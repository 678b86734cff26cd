"""Device-resident closed race — the twin of ``repro.smt.scan_engine``.

Each quantum composes

    machine quantum  ->  fused SYNPA step  ->  device matcher

on the race's device; :func:`run_quanta_scan` races K policies over one
workload for a fixed horizon.  The loop over quanta is a Python loop of
device operations.  Inside it the host reads the device at two
data-dependent exits only: the §5.3 solve's fallback flag (once per synpa
quantum, ``regression.NEED_FB_SYNCS``) and the 2-opt's convergence flag
(at most every ``matching.SYNC_EVERY`` rounds, ``matching.TWO_OPT_SYNCS``).

Random draws are data.  A race takes a ``draws`` object with three methods

* ``noise(q, n)``   -> (n, 4) standard normals (counter noise of quantum q);
* ``phase(q, lam)`` -> (n,) Poisson draws of rate ``lam`` (phase durations);
* ``linux(k, q, n)`` -> ``(x, y, u)``: two slots in [0, n) and a uniform,
  each a (1,) tensor (the k-th policy's migration draw at quantum q).

Draws are keyed per (quantum, purpose) and never per policy or visit
order, so all K policies face an identical workload.  The default,
:class:`TorchDraws`, keys a ``torch.Generator`` on the race's device from
``seed``; it matches the reference's threefry streams in distribution, not
bit for bit.  The initial pairing is host numpy,
``default_rng(seed + 7919)``, bit for bit as in the reference.

Odd populations follow the idle-context convention: a slot whose partner
is the idle vertex runs alone, interference-free, that quantum.

Lanes.  :func:`run_quanta_multi_batched` races the same policies over a
batch of seeds at once: every per-slot tensor of the race takes a leading
lane axis, each quantum's operations run once for all lanes, and a
:class:`LaneDraws` hands lane i the draws of its own seed.  The machine
quantum, the policy steps and the race itself are written over any
leading lane axes, so :func:`run_quanta_scan` is the same code without
one.

Telemetry.  ``telemetry=True`` records one ``CLOSED_FIELDS`` vector a
quantum (:mod:`repro_torch.obs.telemetry`), ``app_telemetry=True`` also one
``APP_FIELDS`` row a slot, on the device; the rings are stacked after the
loop and fetched with the results.  They read the quantum's own slowdown
ratios and the policy's cost matrix, write nothing back, and read no flag
on the host, so a race with rings is the race without them, bit for bit,
with the same host syncs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import isc, matching
from repro_torch.core.synpa import fused_pad, make_fused_step
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.telemetry import (
    APP_FIELDS,
    APP_ST_WIDTH,
    CLOSED_FIELDS,
    AppTelemetryLog,
    TelemetryLog,
)
from repro_torch.smt.machine import MachineParams, PhaseTables, ThroughputResult

#: Version of the port's own draw streams (:class:`TorchDraws`: a
#: ``torch.Generator`` re-seeded per (purpose, quantum[, policy]) through
#: ``numpy.random.SeedSequence``).  They are not the reference's threefry
#: streams, so run exports carry this in place of the reference's
#: ``SCAN_RNG_STREAM_VERSION`` (:mod:`repro_torch.obs.metrics`); bump it
#: when the keying or the draw order changes.
TORCH_DRAW_STREAM_VERSION = "torch-1"


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """float32 tensor mirror of :class:`repro_torch.smt.machine.PhaseTables`
    on one device."""

    n_apps: int
    n_phases: torch.Tensor     # (A,) int64
    comps: torch.Tensor        # (A, Pmax, 4)
    util: torch.Tensor         # (A, Pmax)
    x_fe: torch.Tensor         # (A, Pmax)
    x_be: torch.Tensor         # (A, Pmax)
    duration: torch.Tensor     # (A, Pmax)
    omega: torch.Tensor        # (A,)
    retire: torch.Tensor       # (A,)
    mem_sens: torch.Tensor     # (A,)
    fetch_sens: torch.Tensor   # (A,)

    @classmethod
    def build(cls, tables, device) -> "DeviceTables":
        """From any object with ``PhaseTables``' numpy attributes."""
        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)
        return cls(
            n_apps=int(tables.n_apps),
            n_phases=torch.as_tensor(np.asarray(tables.n_phases),
                                     dtype=torch.int64, device=device),
            comps=f(tables.comps),
            util=f(tables.util),
            x_fe=f(tables.x_fe),
            x_be=f(tables.x_be),
            duration=f(tables.duration),
            omega=f(tables.omega),
            retire=f(tables.retire),
            mem_sens=f(tables.mem_sens),
            fetch_sens=f(tables.fetch_sens),
        )


@dataclasses.dataclass(frozen=True)
class ScanPolicy:
    """One raced policy.

    kind:
      ``"synpa"``   — fused SYNPA step + device matcher (needs ``method``
                      and ``model``): a full sort-seed + 2-opt re-match at
                      the first counter quantum, then at most
                      ``refine_rounds`` 2-opt rounds from the carried
                      pairing each quantum, committing swaps that improve
                      by more than ``refine_eps``;
      ``"static"``  — the initial random pairing, pinned;
      ``"linux"``   — sticky pairing with occasional random migrations
                      (probability ``p_migrate`` per quantum);
      ``"adjacent"`` — the open system's slot-ordered pairing of the
                      active set (:mod:`repro_torch.online.device_sim`
                      only).

    matcher (``"synpa"`` only):
      ``"refine"``  — in the closed race, the full re-match at the first
                      counter quantum and the bounded 2-opt after it; in
                      the open system, the churn repair of the carried
                      pairing (``matching.device_repair_partner``) every
                      quantum;
      ``"full"``    — a fresh sort seed + 2-opt re-match every quantum.

    ``name`` labels the policy in open-system stats; the closed race keys
    its results by the ``policies`` dict instead.
    """

    kind: str = "synpa"
    method: Optional[isc.StackMethod] = None
    model: Optional[object] = None
    matcher: str = "refine"
    refine_eps: float = 1e-2
    refine_rounds: int = 8
    p_migrate: float = 0.03
    name: Optional[str] = None


class _MachineState(NamedTuple):
    phase_idx: torch.Tensor      # (N,) int64
    phase_left: torch.Tensor     # (N,) f32
    total_retired: torch.Tensor  # (N,) f32
    total_cycles: torch.Tensor   # (N,) f32


class TorchDraws:
    """Default draws: a ``torch.Generator`` on ``device``, re-seeded per
    (purpose, quantum[, policy]) from ``seed`` so that every policy of a
    race, and every repeat of it, sees the same numbers."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)

    def _keyed(self, *key: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, *key]).generate_state(
            1, np.uint64)
        self._gen.manual_seed(int(state[0]))
        return self._gen

    def noise(self, q: int, n: int) -> torch.Tensor:
        return torch.randn((n, 4), generator=self._keyed(0, q),
                           device=self.device)

    def phase(self, q: int, lam: torch.Tensor) -> torch.Tensor:
        return torch.poisson(lam, generator=self._keyed(1, q))

    def linux(self, k: int, q: int, n: int):
        g = self._keyed(2, k, q)
        x = torch.randint(0, n, (1,), generator=g, device=self.device)
        y = torch.randint(0, n, (1,), generator=g, device=self.device)
        u = torch.rand((1,), generator=g, device=self.device)
        return x, y, u


class LaneDraws:
    """The draws of a lane-batched run: one draws object per lane, each
    quantum's numbers stacked on a leading lane axis.

    ``noise(q, n)`` -> (L, n, 4), ``phase(q, lam (L, n))`` -> (L, n) and
    ``linux(k, q, n)`` -> three (L, 1) tensors; lane i gets exactly what
    ``lanes[i]`` gives a single-lane run.  Each lane draws apart (two
    small launches a quantum a lane for the machine's noise and phases),
    plus one stack a draw when L > 1."""

    def __init__(self, lanes: Sequence):
        self.lanes = list(lanes)

    @staticmethod
    def _stack(parts):
        return parts[0][None] if len(parts) == 1 else torch.stack(parts)

    def noise(self, q: int, n: int) -> torch.Tensor:
        return self._stack([d.noise(q, n) for d in self.lanes])

    def phase(self, q: int, lam: torch.Tensor) -> torch.Tensor:
        return self._stack([d.phase(q, lam[k])
                            for k, d in enumerate(self.lanes)])

    def linux(self, k: int, q: int, n: int):
        per_lane = [d.linux(k, q, n) for d in self.lanes]
        return tuple(self._stack(list(t)) for t in zip(*per_lane))


def _corun_components_scan(dt: DeviceTables, ph, partner,
                           params: MachineParams, aid=None):
    """Batched interference transform over all slots.

    ``partner[i] == i`` marks a solo slot: the interference terms are
    masked to zero, so its components are exactly the solo components.
    ``aid`` (optional) maps slots to pool rows of ``dt``: the open
    system's slot -> application indirection.  The closed race's slots are
    pool rows (the default).  ``ph``, ``partner`` and ``aid`` may carry
    leading lane axes; partners index within their own lane.
    """
    n = ph.shape[-1]
    idx = torch.arange(n, device=ph.device)
    co = (partner != idx).to(torch.float32)
    if aid is None:
        aid, aidp = idx, partner
        mem, fetch = dt.mem_sens, dt.fetch_sens
    else:
        aidp = aid.gather(-1, partner)
        mem, fetch = dt.mem_sens[aid], dt.fetch_sens[aid]
    c = dt.comps[aid, ph]
    cpi = c.sum(-1)
    php = ph.gather(-1, partner)
    u = dt.util[aidp, php] * co
    f = dt.x_fe[aidp, php] * co
    m = dt.x_be[aidp, php] * co
    return torch.stack(
        [
            c[..., 0] * (1.0 + params.a_disp * u),
            c[..., 1] * (1.0 + params.a_hw * u),
            c[..., 2] * (1.0 + params.a_fe * f)
            + params.e_fe * fetch * f * cpi,
            c[..., 3] * (1.0 + params.a_be * m + params.b_be * mem * m * m)
            + params.e_be * mem * m * cpi,
        ],
        dim=-1,
    )


def _pmu_counters_scan(comps, omega, retire, cycles: float,
                       params: MachineParams, z=None):
    """Batched PMU counters; ``z`` (n, 4) standard normals make the four
    noisy columns lognormal, ``z=None`` gives the noiseless counters."""
    cpi = comps.sum(-1)
    insts = cycles / cpi
    frac = comps / cpi[..., None]
    x_fe, x_be = frac[..., 2], frac[..., 3]
    overlap = omega * torch.minimum(x_fe, x_be)
    noisy_cols = torch.stack(
        [
            cycles * (x_fe + params.overlap_split * overlap),
            cycles * (x_be + (1.0 - params.overlap_split) * overlap),
            insts,
            insts * retire,
        ],
        dim=-1,
    )
    if z is not None:
        noisy_cols = noisy_cols * torch.exp(params.noise_sigma * z)
    return torch.cat(
        [torch.full(cpi.shape + (1,), cycles, dtype=torch.float32,
                    device=comps.device),
         noisy_cols], dim=-1)


def _make_machine_quantum(dt: DeviceTables, params: MachineParams):
    """Closure: one quantum of the fixed-horizon machine,
    ``quantum(state, partner, draws, q) -> (counters, state', slowdown)``,
    and with ``with_ratio=True`` also the per-slot slowdown ratios whose
    mean ``slowdown`` is (the telemetry rings read them).  State and
    partner tensors may carry leading lane axes (then ``slowdown`` has them
    too), matched by the draws' shapes."""
    n = dt.n_apps
    idx = torch.arange(n, device=dt.comps.device)
    cycles = float(np.float32(params.quantum_cycles))

    def quantum(state: _MachineState, partner, draws, q: int,
                with_ratio: bool = False):
        ph = state.phase_idx % dt.n_phases
        comps = _corun_components_scan(dt, ph, partner, params)
        cpi = comps.sum(-1)
        solo_cpi = dt.comps[idx, ph].sum(-1)
        ratio = cpi / solo_cpi
        slowdown = torch.mean(ratio, -1)

        retired = cycles / cpi * dt.retire
        counters = _pmu_counters_scan(comps, dt.omega, dt.retire, cycles,
                                      params, draws.noise(q, n))

        # Phase advance: transitioning slots draw their next duration from
        # the per-quantum Poisson block — pairing-independent, so all raced
        # policies see identical phase trajectories.
        left = state.phase_left - 1.0
        trans = left <= 0.0
        new_idx = state.phase_idx + trans.to(torch.int64)
        lam = dt.duration[idx, new_idx % dt.n_phases]
        drawn = draws.phase(q, lam).to(torch.float32)
        new_left = torch.where(trans, torch.clamp(drawn, min=1.0), left)

        new_state = _MachineState(
            phase_idx=new_idx,
            phase_left=new_left,
            total_retired=state.total_retired + retired,
            total_cycles=state.total_cycles + cycles,
        )
        if with_ratio:
            return counters, new_state, slowdown, ratio
        return counters, new_state, slowdown

    return quantum


def _machine_partner_of(mpart, n: int):
    """Matcher-space partner (P,) -> machine partner (N,): idle/pad -> self."""
    idx = torch.arange(n, device=mpart.device)
    mp = mpart[..., :n]
    return torch.where(mp < n, mp, idx)


def _policy_zeros(mpart, n: int):
    """The policy half of a ring row for a policy that predicts nothing:
    (..., 6) zeros and (..., n) zero per-slot predictions."""
    lanes = mpart.shape[:-1]
    return (torch.zeros(lanes + (6,), device=mpart.device),
            torch.zeros(lanes + (n,), device=mpart.device))


def _make_policy_step(spec: ScanPolicy, k: int, n: int, p_pad: int,
                      valid_p: torch.Tensor, telemetry: bool = False):
    """Closure: ``(q, counters, mpart, st, draws, first) -> (mpart', st')``.

    ``first`` marks the first quantum with counters: the synpa policy then
    runs the full sort-seed + 2-opt re-match instead of refining the
    carried pairing.  Every tensor may carry leading lane axes; the linux
    policy's draws then come one a lane.

    ``telemetry=True`` returns ``(mpart', st', pol, pred)``: ``pol`` the
    policy half of the ring row, ``CLOSED_FIELDS[2:]`` as (..., 6) f32
    (mean predicted cost of the committed pairs, 2-opt rounds, the solve's
    diagnostics), and ``pred`` (..., n) each slot's predicted slowdown,
    half its committed pair's cost.  ``static`` and ``linux`` record
    zeros.
    """
    if spec.kind == "static":
        def step(q, counters, mpart, st, draws, first=False):
            if telemetry:
                return (mpart, st) + _policy_zeros(mpart, n)
            return mpart, st
        return step

    if spec.kind == "linux":
        p_mig = float(spec.p_migrate)

        def step(q, counters, mpart, st, draws, first=False):
            x, y, u = draws.linux(k, q, n)
            px = mpart.gather(-1, x)
            py = mpart.gather(-1, y)
            distinct = (y != x) & (y != px) & (px < n) & (py < n)
            do = (u < p_mig) & distinct
            # Swap x and y between their cores: (px, x)(py, y) ->
            # (px, y)(py, x), written in the reference's order.
            swapped = (mpart.scatter(-1, px, y).scatter(-1, y, px)
                       .scatter(-1, py, x).scatter(-1, x, py))
            out = torch.where(do, swapped, mpart)
            if telemetry:
                return (out, st) + _policy_zeros(mpart, n)
            return out, st
        return step

    if spec.kind != "synpa":
        raise ValueError(f"unknown policy kind {spec.kind!r}")
    if spec.method is None or spec.model is None:
        raise ValueError("synpa scan policy needs a stack method and a fitted model")
    fstep = make_fused_step(spec.method, spec.model, with_diag=telemetry)
    full_budget = 4 * (p_pad // 2)
    idx = torch.arange(n, device=valid_p.device)
    odd = n % 2 == 1
    n_valid = float(max(n + odd, 1))     # the valid vertices of valid_p

    def step(q, counters, mpart, st, draws, first=False):
        partner = _machine_partner_of(mpart, n)
        solve = partner != idx
        masks = torch.stack([solve, ~solve, torch.ones_like(solve),
                             torch.zeros_like(solve)], dim=-2)
        cost, st, *fdiag = fstep(counters, partner, st, masks, odd)
        if first or spec.matcher == "full":
            matched = matching.device_pairs_partner(
                cost, valid_p, eps=spec.refine_eps, max_rounds=full_budget,
                with_rounds=telemetry)
        else:
            matched = matching.device_two_opt_partner(
                cost, mpart, valid_p, eps=spec.refine_eps,
                max_rounds=spec.refine_rounds, with_rounds=telemetry)
        if not telemetry:
            return matched, st
        mpart, rounds = matched
        # Each committed pair's cost appears twice (i -> j and j -> i) over
        # n_valid / 2 pairs, so the two factors of 2 cancel.
        gathered = torch.where(
            valid_p, cost.gather(-1, mpart[..., None])[..., 0], 0.0)
        pred = gathered.sum(-1) / n_valid
        pol = torch.cat([torch.stack([pred, rounds.to(torch.float32)], -1),
                         fdiag[0]], -1)
        return mpart, st, pol, gathered[..., :n] * 0.5

    return step


def _initial_mpart(n: int, p_pad: int, rng: np.random.Generator) -> np.ndarray:
    """Host-built initial matcher-space partner vector.

    The random permutation follows the host schedulers' first random
    pairing (``default_rng(seed + 7919)``); an odd population's leftover
    slot pairs the idle vertex (row ``n``), and padding vertices pair
    consecutively among themselves.
    """
    perm = rng.permutation(n)
    mpart = np.arange(p_pad, dtype=np.int64)
    for k in range(n // 2):
        a, b = int(perm[2 * k]), int(perm[2 * k + 1])
        mpart[a], mpart[b] = b, a
    pads = list(range(n, p_pad))
    if n % 2 == 1:
        solo = int(perm[-1])
        mpart[solo], mpart[n] = n, solo
        pads.remove(n)
    for k in range(0, len(pads), 2):
        a, b = pads[k], pads[k + 1]
        mpart[a], mpart[b] = b, a
    return mpart


def _app_rows(ratio, partner, pred_slot, st):
    """One quantum's ``APP_FIELDS`` block, (..., N, 9): the slot index as
    its app id, the co-runner (-1 when solo), the predicted and true
    slowdowns, their residual where a prediction exists, and the ST
    estimates (zero-padded to four categories)."""
    n = partner.shape[-1]
    idx = torch.arange(n, device=partner.device)
    co = partner != idx
    pred = torch.where(co, pred_slot, 0.0)
    resid = torch.where(pred > 0.0, pred - ratio, 0.0)
    st4 = st[..., :APP_ST_WIDTH]
    if st4.shape[-1] < APP_ST_WIDTH:
        st4 = torch.cat([st4, st4.new_zeros(
            st4.shape[:-1] + (APP_ST_WIDTH - st4.shape[-1],))], -1)
    head = torch.stack([idx.to(torch.float32).expand(partner.shape),
                        torch.where(co, partner, -1).to(torch.float32),
                        pred, ratio, resid], -1)
    return torch.cat([head, st4], -1)


def build_race(tables, params: MachineParams, policies: Sequence[ScanPolicy],
               n_quanta: int, device, telemetry: bool = False,
               app_telemetry: bool = False):
    """K-policy race on ``device``.

    Returns ``race(dt, init_mpart (K, P), init_st (K, N, 4), draws)`` ->
    ``(total_retired (K, N), total_cycles (K, N), slowdown_sum (K,))``.
    Each policy runs quantum 0 on its initial pairing, then quanta
    1..Q-1 of policy step + machine quantum.  With seed lanes,
    ``init_mpart`` (K, L, P), ``init_st`` (K, L, N, 4) and a
    :class:`LaneDraws` of L lanes give outputs with the lane axis after
    the policy axis.

    ``telemetry`` appends the ``CLOSED_FIELDS`` ring, (K[, L], Q, 8), and
    ``app_telemetry`` (which implies it) the ``APP_FIELDS`` ring,
    (K[, L], Q, N, 9).  Quantum 0 runs no policy: its policy fields are
    zero.  Each row reads the state the quantum is about to run.
    """
    telemetry = telemetry or app_telemetry
    device = torch.device(device)
    n = int(tables.n_apps)
    p_pad = fused_pad(n)
    valid_np = np.zeros(p_pad, bool)
    valid_np[:n] = True
    if n % 2 == 1:
        valid_np[n] = True
    valid_p = torch.as_tensor(valid_np, device=device)
    steps = [_make_policy_step(s, k, n, p_pad, valid_p, telemetry=telemetry)
             for k, s in enumerate(policies)]

    def run_one(dt, quantum, policy_step, mpart, st, draws):
        shape = mpart.shape[:-1] + (n,)      # lanes, slots
        state = _MachineState(
            phase_idx=torch.zeros(shape, dtype=torch.int64, device=device),
            phase_left=dt.duration[:, 0].expand(shape).clone(),
            total_retired=torch.zeros(shape, dtype=torch.float32,
                                      device=device),
            total_cycles=torch.zeros(shape, dtype=torch.float32,
                                     device=device),
        )
        tvecs, avecs = [], []

        def run_quantum(state, partner, q, pol=None, pred=None):
            if not telemetry:
                return quantum(state, partner, draws, q)
            counters, state, slow, ratio = quantum(state, partner, draws, q,
                                                   with_ratio=True)
            if pol is None:             # no policy ran: zeros
                pol, pred = _policy_zeros(mpart, n)
            tvecs.append(torch.cat([ratio.mean(-1, keepdim=True),
                                    ratio.amax(-1, keepdim=True), pol], -1))
            if app_telemetry:
                avecs.append(_app_rows(ratio, partner, pred, st))
            return counters, state, slow

        # Quantum 0: the initial random pairing, no counters yet.
        counters, state, slow0 = run_quantum(
            state, _machine_partner_of(mpart, n), 0)
        slows = [slow0]
        for q in range(1, n_quanta):
            mpart, st, *ring = policy_step(q, counters, mpart, st, draws,
                                           first=(q == 1))
            counters, state, slow = run_quantum(
                state, _machine_partner_of(mpart, n), q, *ring)
            slows.append(slow)
        # Summed as the reference does: quanta 0 and 1, then the rest.
        head = slows[0] + slows[1] if len(slows) > 1 else slows[0]
        slow_sum = (head + torch.stack(slows[2:]).sum(0) if len(slows) > 2
                    else head)
        out = (state.total_retired, state.total_cycles, slow_sum)
        if telemetry:
            out += (torch.stack(tvecs, -2),)
        if app_telemetry:
            out += (torch.stack(avecs, -3),)
        return out

    n_out = 3 + int(telemetry) + int(app_telemetry)

    def race(dt: DeviceTables, init_mpart, init_st, draws):
        quantum = _make_machine_quantum(dt, params)
        outs = [run_one(dt, quantum, step, init_mpart[k], init_st[k], draws)
                for k, step in enumerate(steps)]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(n_out))

    return race


def _uniform_stacks(spec: ScanPolicy, n: int) -> np.ndarray:
    ncat = spec.method.n_categories if spec.method is not None else 4
    return np.tile(isc.uniform_stack(ncat), (n, 1))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device, repeats: int):
    """Run ``fn`` once (its output is the result), then ``repeats`` more
    times, each bracketed by ``torch.cuda.synchronize()`` on a GPU: the
    output and the median wall of the timed runs (the first run's when
    ``repeats=0``)."""
    walls: List[float] = []
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    warm = time.perf_counter() - t0
    for _ in range(int(repeats)):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        walls.append(time.perf_counter() - t0)
    return out, float(np.median(walls) if walls else warm)


def _results(names, n: int, n_quanta: int, fetched, per_quantum: float,
             telemetry: bool, app_telemetry: bool, lane=()):
    """``{name: ThroughputResult}`` from a race's fetched outputs (the
    K-policy axis first, then ``lane``'s index), rings attached."""
    out = {}
    for k, name in enumerate(names):
        retired, cycles, slow_sum, *rings = (f[(k,) + lane]
                                            for f in fetched)
        out[name] = ThroughputResult(
            n_apps=n,
            quanta=n_quanta,
            ipc=retired / np.maximum(cycles, 1.0),
            total_retired=float(retired.sum()),
            mean_true_slowdown=float(slow_sum) / max(n_quanta, 1),
            machine_s_per_quantum=per_quantum,
            telemetry=(TelemetryLog(CLOSED_FIELDS, rings[0], policy=name)
                       if telemetry else None),
            app_telemetry=(AppTelemetryLog(APP_FIELDS, rings[1], policy=name)
                           if app_telemetry else None),
        )
    return out


def run_quanta_scan(
    params: MachineParams,
    profiles,
    policies: Dict[str, ScanPolicy],
    n_quanta: int = 20,
    seed: int = 0,
    device=None,
    draws=None,
    repeats: int = 1,
    telemetry: bool = False,
    app_telemetry: bool = False,
) -> Dict[str, ThroughputResult]:
    """Race K policies through one workload for ``n_quanta`` quanta.

    Runs the race once (the result), then ``repeats`` more times, timed,
    and reports the median wall time per quantum in
    ``machine_s_per_quantum`` (the warm run's when ``repeats=0``).  Each
    timed run is bracketed by ``torch.cuda.synchronize()`` on a GPU.
    ``draws`` defaults to :class:`TorchDraws` keyed from ``seed``.  To
    race several seeds, use :func:`run_quanta_multi_batched`: one run for
    all of them.

    ``telemetry=True`` attaches each policy's ``CLOSED_FIELDS`` ring as
    ``ThroughputResult.telemetry``; ``app_telemetry=True`` (which implies
    it) also the ``APP_FIELDS`` ring as ``ThroughputResult.app_telemetry``.
    The results are those of a run without rings, bit for bit.
    """
    telemetry = telemetry or app_telemetry
    device = resolve_device(device)
    tables = PhaseTables.build(profiles)
    n = int(tables.n_apps)
    p_pad = fused_pad(n)
    specs = list(policies.values())
    race = build_race(tables, params, specs, n_quanta, device,
                      telemetry=telemetry, app_telemetry=app_telemetry)
    with obs_trace.span("scan.commit"):
        init_mpart = torch.as_tensor(np.stack([
            _initial_mpart(n, p_pad, np.random.default_rng(seed + 7919))
            for _ in specs
        ]), device=device)
        init_st = torch.as_tensor(
            np.stack([_uniform_stacks(s, n) for s in specs]), device=device)
        dt = DeviceTables.build(tables, device)
    draws = draws if draws is not None else TorchDraws(seed, device)

    with obs_trace.span("scan.dispatch", n=n, quanta=n_quanta,
                        repeats=repeats):
        out, wall = _timed(lambda: race(dt, init_mpart, init_st, draws),
                           device, repeats)
    per_quantum = wall / max(n_quanta, 1)
    with obs_trace.span("scan.stats"):
        fetched = [o.cpu().numpy() for o in out]
        return _results(list(policies), n, n_quanta, fetched, per_quantum,
                        telemetry, app_telemetry)


def run_quanta_multi_batched(
    machine,
    profiles,
    policies: Dict[str, ScanPolicy],
    seeds: Sequence[int],
    n_quanta: int = 20,
    tables: Optional[PhaseTables] = None,
    repeats: int = 1,
    device=None,
    draws=None,
    telemetry: bool = False,
    app_telemetry: bool = False,
) -> Dict[str, List[ThroughputResult]]:
    """The closed race over a batch of seeds at once: seed lanes on a
    leading axis of every per-slot tensor, each quantum's operations run
    once for all of them.

    Returns ``{policy_name: [ThroughputResult, ...]}`` in ``seeds`` order.
    Lane i starts from the initial pairing of ``default_rng(seeds[i] +
    7919)`` and sees the draws of ``seeds[i]``: ``draws`` (a
    :class:`LaneDraws` or alike) defaults to one :class:`TorchDraws` a
    seed, so each lane's numbers are those :func:`run_quanta_scan` of
    that seed draws.  Each lane keeps its own GN and 2-opt freezes; the
    host reads the fallback and 2-opt flags once for all lanes.

    Runs the batch once (the result), then ``repeats`` more times, timed;
    per-lane ``machine_s_per_quantum`` is the batch's median wall (the
    first run's when ``repeats=0``) over ``len(seeds) * n_quanta``.
    ``machine`` supplies the machine params.  ``telemetry`` and
    ``app_telemetry`` attach each lane's rings, as
    :func:`run_quanta_scan` does; each lane's rings are those of its single
    race, bit for bit.
    """
    telemetry = telemetry or app_telemetry
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("a batched race needs at least one seed lane")
    device = resolve_device(device)
    params = machine.params
    tables = tables if tables is not None else PhaseTables.build(profiles)
    n = int(tables.n_apps)
    p_pad = fused_pad(n)
    specs = list(policies.values())
    race = build_race(tables, params, specs, n_quanta, device,
                      telemetry=telemetry, app_telemetry=app_telemetry)
    init_mpart = torch.as_tensor(np.stack([np.stack([
        _initial_mpart(n, p_pad, np.random.default_rng(seed + 7919))
        for seed in seeds]) for _ in specs]), device=device)
    init_st = torch.as_tensor(np.stack([
        np.stack([_uniform_stacks(s, n)] * len(seeds)) for s in specs]),
        device=device)
    dt = DeviceTables.build(tables, device)
    if draws is None:
        draws = LaneDraws([TorchDraws(seed, device) for seed in seeds])

    with obs_trace.span("scan.dispatch", n=n, quanta=n_quanta,
                        lanes=len(seeds), repeats=repeats):
        out, wall = _timed(lambda: race(dt, init_mpart, init_st, draws),
                           device, repeats)
    per_quantum = wall / max(len(seeds) * n_quanta, 1)
    with obs_trace.span("scan.stats", lanes=len(seeds)):
        fetched = [o.cpu().numpy() for o in out]
        lanes = [_results(list(policies), n, n_quanta, fetched, per_quantum,
                          telemetry, app_telemetry, lane=(i,))
                 for i in range(len(seeds))]
    return {name: [lane[name] for lane in lanes] for name in policies}
