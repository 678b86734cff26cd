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
(padding sentinels, the idle-context vertex for odd populations).
"""

from __future__ import annotations

import torch

from repro_torch.core import isc, matching, regression
from repro_torch.kernels.pair_score.ref import DIAG as _KERNEL_DIAG
from repro_torch.kernels.pair_score.ref import IDLE_COST as _KERNEL_IDLE


def fused_pad(n: int) -> int:
    """Padded vertex count of the fused pipeline: the smallest multiple of 8
    with room for the idle-context vertex (row ``n``)."""
    return max(8, ((n + 1 + 7) // 8) * 8)


def make_fused_step(
    method: isc.StackMethod,
    model: regression.CategoryModel,
    gn_steps: int = regression.GN_STEPS,
    hb_steps: int = 80,
    lr: float = 1.5,
    with_diag: bool = False,
):
    """The fused per-quantum SYNPA step (Steps 0-2 + cost preparation),
    with the damped Gauss-Newton §5.3 solver (``hb_steps`` is its
    heavy-ball fallback budget).

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
        si, sj, idiag = regression._gn_with_fallback(
            model, fi, fj, gn_steps=gn_steps, hb_steps=hb_steps, lr=lr,
            return_diag=True)
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
