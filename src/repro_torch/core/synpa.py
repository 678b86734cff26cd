"""SYNPA's fused per-quantum decision (paper §5), on tensors.

Every quantum a SYNPA policy:

  Step 0. reads the PMU counters of every application and builds its measured
          ISC stack with the variant's (LT100, GT100) repair pair (Table 2);
  Step 1. applies the Eq. 4 model *inversely* to the current pairs to recover
          the stack each application would have had running alone (ST mode);
  Step 2. applies the forward model to every candidate pair (both directions)
          to predict each pair's mutual slowdown — the ``pair_score`` kernel;
  Step 3. matches on the predicted-degradation matrix
          (``repro_torch.core.matching``).

:func:`make_fused_step` is Steps 0-2 plus the matching cost preparation
(padding sentinels, the idle-context vertex for odd populations).  The
closed race (:mod:`repro_torch.smt.scan_engine`) and the open system's
device engine keep the matching on the device too; the host tier —
:class:`SynpaScheduler` here and the streaming allocator
(:mod:`repro_torch.online.allocator`) — copies the prepared cost matrix to
the host once a quantum (:func:`host_cost`) and matches it there with the
exact matchers of :mod:`repro_torch.core.matching`, as the reference does.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.core import isc, matching, regression
from repro_torch.kernels.pair_score.ref import DIAG as _KERNEL_DIAG
from repro_torch.kernels.pair_score.ref import IDLE_COST as _KERNEL_IDLE

Pair = Tuple[int, int]

#: Device-to-host copies of a prepared cost matrix (:func:`host_cost`):
#: the host tier's one sync of its own a quantum.
HOST_COST_COPIES = 0


class Scheduler:
    """Base interface shared by SYNPA, the baselines and Hy-Sched."""

    name = "base"

    def reset(self, n_apps: int, rng: np.random.Generator, machine=None) -> None:
        self.n_apps = n_apps
        self.rng = rng
        self.machine = machine

    def schedule(self, quantum: int, samples, prev_pairs: List[Pair]) -> List[Pair]:
        raise NotImplementedError

    # helpers ---------------------------------------------------------------
    def _random_pairs(self) -> List[Pair]:
        """Random perfect pairing; an odd population's leftover app (the
        last of the permutation) is left uncovered and runs solo."""
        perm = self.rng.permutation(self.n_apps)
        return [(int(perm[2 * k]), int(perm[2 * k + 1])) for k in range(self.n_apps // 2)]

    @staticmethod
    def _have_samples(samples) -> bool:
        """True once every application has a PMU readout."""
        if samples is None:
            return False
        if isinstance(samples, np.ndarray):
            return True
        return not any(s is None for s in samples)

    @staticmethod
    def _counters_array(samples) -> np.ndarray:
        """(N, 5) array: cycles, stall_fe, stall_be, inst_spec, inst_retired.

        The vectorised machine hands policies the counter matrix directly;
        the scalar engine hands a list of :class:`PMUSample`.
        """
        if isinstance(samples, np.ndarray):
            return samples.astype(np.float32)
        return np.array([s.as_tuple() for s in samples], dtype=np.float32)


def _partner_index(pairs: Sequence[Pair], n: int) -> np.ndarray:
    """Partner array of a pairing; an uncovered (solo) slot partners itself."""
    partner = np.arange(n, dtype=np.int32)
    for i, j in pairs:
        partner[i] = j
        partner[j] = i
    return partner


def check_impl(impl: str) -> None:
    """The reference picks the Step-2 backend with ``impl``; the port picks
    it by device (the ``pair_score`` kernel on ``cuda``, its plain version
    on the CPU), so only ``"auto"`` is accepted."""
    if impl != "auto":
        raise ValueError(
            f"impl={impl!r}: the port picks the pair_score backend by "
            "device (the kernel on cuda, the plain version on the CPU); "
            "only 'auto' is accepted")


def host_cost(cost: torch.Tensor) -> np.ndarray:
    """The prepared cost matrix on the host: one device-to-host copy,
    counted in :data:`HOST_COST_COPIES`."""
    global HOST_COST_COPIES
    HOST_COST_COPIES += 1
    return cost.cpu().numpy()


def fused_pad(n: int) -> int:
    """Padded vertex count of the fused pipeline: the smallest multiple of 8
    with room for the idle-context vertex (row ``n``)."""
    return max(8, ((n + 1 + 7) // 8) * 8)


def make_fused_step(
    method: isc.StackMethod,
    model: regression.CategoryModel,
    impl: str = "auto",
    solver: str = "gn",
    gn_steps: int = regression.GN_STEPS,
    hb_steps: int = 80,
    lr: float = 1.5,
    warm: bool = False,
    with_diag: bool = False,
):
    """The fused per-quantum SYNPA step (Steps 0-2 + cost preparation).

    ``solver`` picks the §5.3 engine: ``"gn"`` (damped Gauss-Newton with
    the heavy-ball fallback; ``hb_steps`` is the fallback budget) starts
    from the measured fractions, so ``warm`` is ignored; ``"hb"`` is the
    heavy-ball solve alone (``hb_steps`` a trajectory), which with
    ``warm=True`` starts its second trajectory from ``prev_st``.  ``impl``
    is kept for call compatibility and accepts ``"auto"`` only: the
    backend follows the device.

    Returns ``step(counters, partner, prev_st, masks, idle)`` with, for
    capacity ``n`` and ``P = fused_pad(n)``:

    * ``counters``  (n, 5) f32 — previous-quantum PMU rows by slot;
    * ``partner``   (n,)  int — co-runner slot (self for solo/no-partner);
    * ``prev_st``   (n, 4) f32 — carried ST estimates; rows that do not
      solve pass through;
    * ``masks``     (4, n) bool — rows *solve* (slot co-ran and its
      estimate should refresh), *solo* (slot ran alone: its measured
      fractions are its ST stack), *valid* (slot hosts an application),
      *fresh* (reset the slot to the uniform placeholder);
    * ``idle``      bool — augment the idle-context vertex (row ``n``)
      with :data:`repro_torch.core.matching.IDLE_COST` edges: a host bool
      (the closed race), or a one-element bool tensor on the counters'
      device (the open system, whose population parity is a device
      value), which the ``pair_score`` kernel reads itself, so the host
      never waits for it;

    and returns ``(cost (P, P) f32, st (n, 4) f32)``.  Each co-running pair
    is solved once, by its lower-index side, and both slots receive their
    estimate from that single solve.  The cost matrix, sentinels and idle
    edges included, comes from one ``pair_score`` call (one kernel launch
    on the card).

    Lanes: with ``counters`` (L, n, 5), ``partner`` (L, n), ``prev_st``
    (L, n, 4), ``masks`` (L, 4, n) and ``idle`` a host bool or an (L,)
    bool tensor, the step runs L independent lanes at once and returns
    ``cost (L, P, P)`` and ``st (L, n, 4)``: the pair ordering, the rank
    gathers and the delivery run along each lane's last axis, the solve
    takes every lane's pairs together (one fallback-flag read for all),
    and the cost matrices come from one ``pair_score`` launch.

    ``with_diag=True`` returns ``(cost, st, diag)``: ``diag`` (4,) f32
    (``(L, 4)`` with lanes) is the solve's diagnostics reduced over the
    quantum's valid pair solves, in
    :data:`repro_torch.obs.telemetry.FUSED_DIAG_FIELDS` order —
    [gn_iters_mean, gn_iters_max, gn_residual_max, gn_fallbacks].  The
    solve computes them either way, so ``cost`` and ``st`` are the same
    bit for bit.
    """
    check_impl(impl)
    if solver not in ("gn", "hb"):
        raise ValueError(f"unknown solver {solver!r}")
    # The kernel's padding sentinel and the matcher's must be the same
    # value, or padded rows could out-compete real edges in the matching.
    assert _KERNEL_DIAG == matching.BIG, (_KERNEL_DIAG, matching.BIG)
    assert _KERNEL_IDLE == matching.IDLE_COST, (_KERNEL_IDLE,
                                                matching.IDLE_COST)
    # Copied to the model's device once: a host-to-device copy inside the
    # step would synchronise the host with the device every quantum.
    uniform = torch.as_tensor(isc.uniform_stack(method.n_categories),
                              device=model.coeffs.device)

    def rows_of(x, k):
        """``x[l, k[l, r]]`` for every lane l and row r: (L, m, C)."""
        return x.gather(-2, k[..., None].expand(k.shape + x.shape[-1:]))

    def lanes_step(counters, partner, prev_st, masks, idle):
        device = counters.device
        solve_mask, solo_mask, valid_mask, fresh_mask = masks.unbind(-2)
        n = counters.shape[-2]
        p = fused_pad(n)
        idx = torch.arange(n, device=device)

        # Step 0: measured SMT stack fractions of every slot.
        raw = isc.raw_stack(counters[..., 0], counters[..., 1],
                            counters[..., 2], counters[..., 3])
        frac = isc.build_stack(raw, method)

        # Step 1: one inverse solve per co-running pair, by its lower-index
        # side; the pair-firsts go to the front in index order.
        first = solve_mask & (idx < partner)
        order = torch.argsort((~first).to(torch.int32), dim=-1, stable=True)
        take = order[..., : n // 2]
        p_take = partner.gather(-1, take)
        valid = first.gather(-1, take)
        v1 = valid[..., None]
        fi = torch.where(v1, rows_of(frac, take), uniform)
        fj = torch.where(v1, rows_of(frac, p_take), uniform)
        if solver == "gn":
            si, sj, idiag = regression._gn_with_fallback(
                model, fi, fj, gn_steps=gn_steps, hb_steps=hb_steps, lr=lr,
                return_diag=True)
        else:
            ii = ij = None
            if warm:
                ii = torch.where(v1, rows_of(prev_st, take), uniform)
                ij = torch.where(v1, rows_of(prev_st, p_take), uniform)
            si, sj = regression._hb_best_of(model, fi, fj, hb_steps, lr,
                                            init_i=ii, init_j=ij)
            idiag = None
            if with_diag:
                idiag = regression.InverseDiag(
                    iters=torch.full(valid.shape, hb_steps,
                                     dtype=torch.int32, device=device),
                    residual=regression.inverse_residual(model, fi, fj,
                                                         si, sj),
                    fallback=torch.zeros_like(valid))
        # Deliver the pair solves by gather: slot s is the solving side of
        # pair rank[s] when first[s] (estimate si), and the partner side of
        # pair rank[partner[s]] when its partner solves (estimate sj).
        rank = torch.cumsum(first.to(torch.int64), -1) - 1
        k1 = torch.clamp(rank, 0, n // 2 - 1)
        k2 = torch.clamp(rank.gather(-1, partner), 0, n // 2 - 1)
        sec = first.gather(-1, partner)
        st = torch.where(first[..., None], rows_of(si, k1),
                         torch.where(sec[..., None], rows_of(sj, k2),
                                     prev_st))
        # A slot that ran alone measured its ST stack directly.
        st = torch.where(solo_mask[..., None], frac, st)
        # Arrivals reset to the uniform placeholder.
        st = torch.where(fresh_mask[..., None], uniform, st)

        # Step 2 and the Step 3 prep in one call: all-pairs Eq. 4 scoring
        # into the padded (P, P) matrices, inactive slots sentineled out,
        # the idle vertex (row n) wired when ``idle``.
        if isinstance(idle, torch.Tensor):   # the kernel reads the flags
            idle_row, flag = n, idle.reshape(-1)
        else:
            idle_row, flag = (n if idle else -1), None
        cost = regression.pair_cost_matrix(
            model, st, n_valid=n, valid=valid_mask.contiguous(),
            idle_row=idle_row, p=p, idle_flag=flag)
        if not with_diag:
            return cost, st
        # The per-row diagnostics reduced over each lane's valid solves
        # (masked rows solved placeholder systems).
        nv = torch.clamp(valid.sum(-1).to(torch.float32), min=1.0)
        itf = torch.where(valid, idiag.iters.to(torch.float32), 0.0)
        diag = torch.stack([
            itf.sum(-1) / nv,
            itf.amax(-1),
            torch.where(valid, idiag.residual, 0.0).amax(-1),
            (valid & idiag.fallback).sum(-1).to(torch.float32),
        ], -1)
        return cost, st, diag

    def step(counters, partner, prev_st, masks, idle):
        if counters.dim() == 3:
            return lanes_step(counters, partner, prev_st, masks, idle)
        # One lane: the same step on a lane axis of 1.
        if isinstance(idle, torch.Tensor):
            idle = idle.reshape(1)
        out = lanes_step(counters[None], partner[None], prev_st[None],
                         masks[None], idle)
        return tuple(o[0] for o in out)

    return step


def make_synpa_pipeline(
    method: isc.StackMethod,
    model: regression.CategoryModel,
    impl: str = "auto",
    n_steps: int = 80,
    solver: str = "gn",
    gn_steps: int = regression.GN_STEPS,
    device=None,
):
    """PMU counters + current partners -> pair costs, on ``device``
    (``cuda`` unless the caller passes ``"cpu"``; the model is moved
    there).

    Returns ``fn(counters (N,5), partner (N,)) -> (cost (N,N), st (N,4))``
    — the closed-population view of :func:`make_fused_step` (every slot
    active and co-running, no idle vertex), as tensors on ``device``.
    ``n_steps`` is the heavy-ball budget: the fallback's under
    ``solver="gn"``, the whole solve's under ``solver="hb"``.  ``impl``
    accepts ``"auto"`` only.
    """
    dev = resolve_device(device)
    model = model.to(dev)
    step = make_fused_step(method, model, impl=impl, solver=solver,
                           gn_steps=gn_steps, hb_steps=n_steps, warm=False)
    uniform = torch.as_tensor(isc.uniform_stack(method.n_categories),
                              device=dev)

    def pipeline(counters, partner):
        counters = to_device(counters, torch.float32, dev)
        partner = to_device(partner, torch.int64, dev)
        n = counters.shape[0]
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        zeros = torch.zeros_like(ones)
        masks = torch.stack([ones, zeros, ones, zeros])
        cost, st = step(counters, partner, uniform.expand(n, -1), masks,
                        False)
        return cost[:n, :n], st

    return pipeline


class SynpaScheduler(Scheduler):
    """One member of the SYNPA family, e.g. SYNPA4_R-FEBE.

    Each quantum the counters go to ``device`` (``cuda`` unless the caller
    passes ``"cpu"``; the model is moved there), the fused step runs there
    (one ``pair_score`` launch on the card), and the (P, P) cost matrix
    comes back in one copy (:func:`host_cost`) for the host matcher
    (:func:`repro_torch.core.matching.min_cost_pairs`: exact blossom up to
    ``BLOSSOM_MAX_N``, tiled above).

    Odd populations ride the idle-context convention: the fused step wires
    the idle vertex (row ``n``) into the prepared cost matrix and whoever
    the matcher pairs with it is left uncovered — it runs alone that
    quantum.

    ``timings`` holds, for every quantum that ran the step, the host
    clock's ``(step_s, copy_s, match_s)``: the fused step until it returns
    (its fallback-flag read waits for the solve), the cost copy (which
    waits for the kernel) and the host matcher.
    """

    def __init__(
        self,
        method: isc.StackMethod,
        model: regression.CategoryModel,
        name: Optional[str] = None,
        matcher: str = "auto",
        pair_impl: str = "auto",
        solver: str = "gn",
        n_steps: int = 80,
        device=None,
    ):
        self.device = resolve_device(device)
        self.method = method
        self.model = model.to(self.device)
        self.name = name or f"SYNPA{method.n_categories}_{method.name.split('_', 1)[1]}"
        self.matcher = matcher
        self._uniform = torch.as_tensor(
            isc.uniform_stack(method.n_categories), device=self.device)
        self._step = make_fused_step(
            method, self.model, impl=pair_impl, solver=solver,
            hb_steps=n_steps, warm=False,
        )
        self.timings: List[Tuple[float, float, float]] = []

    def reset(self, n_apps: int, rng: np.random.Generator, machine=None) -> None:
        super().reset(n_apps, rng, machine)
        self.timings = []

    def schedule(self, quantum, samples, prev_pairs):
        if not self._have_samples(samples) or not prev_pairs:
            return self._random_pairs()
        n = self.n_apps
        odd = n % 2 == 1
        dev = self.device
        counters = self._counters_array(samples)
        partner = _partner_index(prev_pairs, n)
        idx = np.arange(n)
        solve = partner != idx        # co-ran last quantum
        masks = np.stack([
            solve,                    # refresh the estimate via the inverse
            ~solve,                   # a solo slot measured its ST directly
            np.ones(n, bool),         # every slot is active
            np.zeros(n, bool),        # no arrivals in a closed population
        ])
        t0 = time.perf_counter()
        cost, _st = self._step(
            to_device(counters, torch.float32, dev),
            to_device(partner, torch.int64, dev),
            self._uniform.expand(n, -1),
            to_device(masks, torch.bool, dev),
            odd,
        )
        t1 = time.perf_counter()
        host = host_cost(cost)
        t2 = time.perf_counter()
        rows = list(range(n)) + ([n] if odd else [])
        compact = matching.compact_cost(host, rows)
        pairs = matching.min_cost_pairs(compact, method=self.matcher)  # Step 3
        if odd:
            # Drop the idle pair: its app runs solo this quantum.
            pairs = [(a, b) for a, b in pairs if n not in (a, b)]
        self.timings.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        return pairs
