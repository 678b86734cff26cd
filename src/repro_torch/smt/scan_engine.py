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
from repro_torch.smt.machine import MachineParams, PhaseTables, ThroughputResult


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
                      (probability ``p_migrate`` per quantum).
    """

    kind: str = "synpa"
    method: Optional[isc.StackMethod] = None
    model: Optional[object] = None
    refine_eps: float = 1e-2
    refine_rounds: int = 8
    p_migrate: float = 0.03


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


def _corun_components_scan(dt: DeviceTables, ph, partner,
                           params: MachineParams):
    """Batched interference transform over all slots.

    ``partner[i] == i`` marks a solo slot: the interference terms are
    masked to zero, so its components are exactly the solo components.
    """
    n = ph.shape[0]
    idx = torch.arange(n, device=ph.device)
    co = (partner != idx).to(torch.float32)
    c = dt.comps[idx, ph]
    cpi = c.sum(-1)
    php = ph[partner]
    u = dt.util[partner, php] * co
    f = dt.x_fe[partner, php] * co
    m = dt.x_be[partner, php] * co
    mem = dt.mem_sens
    fetch = dt.fetch_sens
    return torch.stack(
        [
            c[:, 0] * (1.0 + params.a_disp * u),
            c[:, 1] * (1.0 + params.a_hw * u),
            c[:, 2] * (1.0 + params.a_fe * f) + params.e_fe * fetch * f * cpi,
            c[:, 3] * (1.0 + params.a_be * m + params.b_be * mem * m * m)
            + params.e_be * mem * m * cpi,
        ],
        dim=-1,
    )


def _pmu_counters_scan(comps, omega, retire, cycles: float,
                       params: MachineParams, z=None):
    """Batched PMU counters; ``z`` (n, 4) standard normals make the four
    noisy columns lognormal, ``z=None`` gives the noiseless counters."""
    n = comps.shape[0]
    cpi = comps.sum(-1)
    insts = cycles / cpi
    frac = comps / cpi[:, None]
    x_fe, x_be = frac[:, 2], frac[:, 3]
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
        [torch.full((n, 1), cycles, dtype=torch.float32, device=comps.device),
         noisy_cols], dim=-1)


def _make_machine_quantum(dt: DeviceTables, params: MachineParams):
    """Closure: one quantum of the fixed-horizon machine,
    ``quantum(state, partner, draws, q) -> (counters, state', slowdown)``."""
    n = dt.n_apps
    idx = torch.arange(n, device=dt.comps.device)
    cycles = float(np.float32(params.quantum_cycles))

    def quantum(state: _MachineState, partner, draws, q: int):
        ph = state.phase_idx % dt.n_phases
        comps = _corun_components_scan(dt, ph, partner, params)
        cpi = comps.sum(-1)
        solo_cpi = dt.comps[idx, ph].sum(-1)
        slowdown = torch.mean(cpi / solo_cpi)

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
        return counters, new_state, slowdown

    return quantum


def _machine_partner_of(mpart, n: int):
    """Matcher-space partner (P,) -> machine partner (N,): idle/pad -> self."""
    idx = torch.arange(n, device=mpart.device)
    mp = mpart[:n]
    return torch.where(mp < n, mp, idx)


def _make_policy_step(spec: ScanPolicy, k: int, n: int, p_pad: int,
                      valid_p: torch.Tensor):
    """Closure: ``(q, counters, mpart, st, draws, first) -> (mpart', st')``.

    ``first`` marks the first quantum with counters: the synpa policy then
    runs the full sort-seed + 2-opt re-match instead of refining the
    carried pairing.
    """
    if spec.kind == "static":
        def step(q, counters, mpart, st, draws, first=False):
            return mpart, st
        return step

    if spec.kind == "linux":
        p_mig = float(spec.p_migrate)

        def step(q, counters, mpart, st, draws, first=False):
            x, y, u = draws.linux(k, q, n)
            px = mpart[x]
            py = mpart[y]
            distinct = (y != x) & (y != px) & (px < n) & (py < n)
            do = (u < p_mig) & distinct
            # Swap x and y between their cores: (px, x)(py, y) ->
            # (px, y)(py, x), written in the reference's order.
            swapped = (mpart.scatter(0, px, y).scatter(0, y, px)
                       .scatter(0, py, x).scatter(0, x, py))
            return torch.where(do, swapped, mpart), st
        return step

    if spec.kind != "synpa":
        raise ValueError(f"unknown policy kind {spec.kind!r}")
    if spec.method is None or spec.model is None:
        raise ValueError("synpa scan policy needs a stack method and a fitted model")
    fstep = make_fused_step(spec.method, spec.model)
    full_budget = 4 * (p_pad // 2)
    idx = torch.arange(n, device=valid_p.device)
    odd = n % 2 == 1

    def step(q, counters, mpart, st, draws, first=False):
        partner = _machine_partner_of(mpart, n)
        solve = partner != idx
        masks = torch.stack([solve, ~solve, torch.ones_like(solve),
                             torch.zeros_like(solve)])
        cost, st = fstep(counters, partner, st, masks, odd)
        if first:
            mpart = matching.device_pairs_partner(
                cost, valid_p, eps=spec.refine_eps, max_rounds=full_budget)
        else:
            mpart = matching.device_two_opt_partner(
                cost, mpart, valid_p, eps=spec.refine_eps,
                max_rounds=spec.refine_rounds)
        return mpart, st

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


def build_race(tables, params: MachineParams, policies: Sequence[ScanPolicy],
               n_quanta: int, device):
    """K-policy race on ``device``.

    Returns ``race(dt, init_mpart (K, P), init_st (K, N, 4), draws)`` ->
    ``(total_retired (K, N), total_cycles (K, N), slowdown_sum (K,))``.
    Each policy runs quantum 0 on its initial pairing, then quanta
    1..Q-1 of policy step + machine quantum.
    """
    device = torch.device(device)
    n = int(tables.n_apps)
    p_pad = fused_pad(n)
    valid_np = np.zeros(p_pad, bool)
    valid_np[:n] = True
    if n % 2 == 1:
        valid_np[n] = True
    valid_p = torch.as_tensor(valid_np, device=device)
    steps = [_make_policy_step(s, k, n, p_pad, valid_p)
             for k, s in enumerate(policies)]

    def run_one(dt, quantum, policy_step, mpart, st, draws):
        state = _MachineState(
            phase_idx=torch.zeros(n, dtype=torch.int64, device=device),
            phase_left=dt.duration[:, 0].clone(),
            total_retired=torch.zeros(n, dtype=torch.float32, device=device),
            total_cycles=torch.zeros(n, dtype=torch.float32, device=device),
        )
        # Quantum 0: the initial random pairing, no counters yet.
        counters, state, slow0 = quantum(
            state, _machine_partner_of(mpart, n), draws, 0)
        slows = [slow0]
        for q in range(1, n_quanta):
            mpart, st = policy_step(q, counters, mpart, st, draws,
                                    first=(q == 1))
            counters, state, slow = quantum(
                state, _machine_partner_of(mpart, n), draws, q)
            slows.append(slow)
        # Summed as the reference does: quanta 0 and 1, then the rest.
        head = slows[0] + slows[1] if len(slows) > 1 else slows[0]
        slow_sum = head + torch.stack(slows[2:]).sum() if len(slows) > 2 else head
        return state.total_retired, state.total_cycles, slow_sum

    def race(dt: DeviceTables, init_mpart, init_st, draws):
        quantum = _make_machine_quantum(dt, params)
        outs = [run_one(dt, quantum, step, init_mpart[k], init_st[k], draws)
                for k, step in enumerate(steps)]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(3))

    return race


def _uniform_stacks(spec: ScanPolicy, n: int) -> np.ndarray:
    ncat = spec.method.n_categories if spec.method is not None else 4
    return np.tile(isc.uniform_stack(ncat), (n, 1))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_quanta_scan(
    params: MachineParams,
    profiles,
    policies: Dict[str, ScanPolicy],
    n_quanta: int = 20,
    seed: int = 0,
    device=None,
    draws=None,
    repeats: int = 1,
) -> Dict[str, ThroughputResult]:
    """Race K policies through one workload for ``n_quanta`` quanta.

    Runs the race once (the result), then ``repeats`` more times, timed,
    and reports the median wall time per quantum in
    ``machine_s_per_quantum`` (the warm run's when ``repeats=0``).  Each
    timed run is bracketed by ``torch.cuda.synchronize()`` on a GPU.
    ``draws`` defaults to :class:`TorchDraws` keyed from ``seed``.
    """
    device = resolve_device(device)
    tables = PhaseTables.build(profiles)
    n = int(tables.n_apps)
    p_pad = fused_pad(n)
    specs = list(policies.values())
    race = build_race(tables, params, specs, n_quanta, device)
    init_mpart = torch.as_tensor(np.stack([
        _initial_mpart(n, p_pad, np.random.default_rng(seed + 7919))
        for _ in specs
    ]), device=device)
    init_st = torch.as_tensor(
        np.stack([_uniform_stacks(s, n) for s in specs]), device=device)
    dt = DeviceTables.build(tables, device)
    draws = draws if draws is not None else TorchDraws(seed, device)

    walls: List[float] = []
    _sync(device)
    t0 = time.perf_counter()
    out = race(dt, init_mpart, init_st, draws)
    _sync(device)
    warm = time.perf_counter() - t0
    for _ in range(int(repeats)):
        _sync(device)
        t0 = time.perf_counter()
        race(dt, init_mpart, init_st, draws)
        _sync(device)
        walls.append(time.perf_counter() - t0)
    per_quantum = float(np.median(walls) if walls else warm) / max(n_quanta, 1)

    retired, cycles, slow_sum = (o.cpu().numpy() for o in out)
    results: Dict[str, ThroughputResult] = {}
    for k, name in enumerate(policies):
        ipc = retired[k] / np.maximum(cycles[k], 1.0)
        results[name] = ThroughputResult(
            n_apps=n,
            quanta=n_quanta,
            ipc=ipc,
            total_retired=float(retired[k].sum()),
            mean_true_slowdown=float(slow_sum[k]) / max(n_quanta, 1),
            machine_s_per_quantum=per_quantum,
        )
    return results
