"""Model building — the paper's §5.4 methodology, run on the simulator.

1. Every *training* application (22 of 28) runs alone; per-quantum PMU samples
   are recorded along with the phase the app was in.
2. All pairs of training applications run together in SMT mode; per-quantum
   samples are recorded for both threads.
3. For each SYNPA variant's stack method, solo and SMT samples are repaired
   into ISC stacks, a random subset of quanta is selected, and the Eq. 4
   coefficients are fit per category by least squares.

The campaign is host numpy (its RNG stream is the reference's, draw for
draw); the stacks are repaired in float32 on the CPU and the fit runs on
the requested device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import isc, regression
from repro_torch.smt.apps import AppProfile, train_profiles
from repro_torch.smt.machine import (
    PhaseTables,
    SMTMachine,
    corun_components_batched,
    pmu_counters_batched,
)


@dataclasses.dataclass
class ProfilingData:
    """Raw profiling runs shared by all stack methods."""

    app_names: List[str]
    solo_counters: np.ndarray      # (A, Q_solo, 5)
    solo_phases: np.ndarray        # (A, Q_solo) phase ids
    pair_index: List[Tuple[int, int]]
    pair_counters: np.ndarray      # (P, Q_pair, 2, 5)
    pair_phases: np.ndarray        # (P, Q_pair, 2) phase ids of each thread


def collect_profiles(
    machine: SMTMachine,
    profiles: Optional[Sequence[AppProfile]] = None,
    solo_quanta: int = 60,
    pair_quanta: int = 12,
    seed: int = 1234,
) -> ProfilingData:
    """Run the solo + all-pairs profiling campaign (paper §5.4)."""
    profiles = list(profiles) if profiles is not None else train_profiles()
    rng = np.random.default_rng(seed)
    a = len(profiles)

    solo_counters = np.zeros((a, solo_quanta, 5), dtype=np.float64)
    solo_phases = np.zeros((a, solo_quanta), dtype=np.int32)
    for ai, prof in enumerate(profiles):
        samples, phases = machine.run_solo(prof, solo_quanta, rng=rng)
        solo_counters[ai] = np.array([s.as_tuple() for s in samples])
        solo_phases[ai] = np.array(phases)

    pair_index = list(itertools.combinations(range(a), 2))
    p = len(pair_index)
    pair_counters = np.zeros((p, pair_quanta, 2, 5), dtype=np.float64)
    pair_phases = np.zeros((p, pair_quanta, 2), dtype=np.int32)
    params = machine.params

    # All pairs advance together: each quantum is two batched corun
    # transforms + one batched counter emission over the 2P threads.
    tables = PhaseTables.build(profiles)
    i_arr = np.array([i for i, _ in pair_index], np.int64)
    j_arr = np.array([j for _, j in pair_index], np.int64)
    # Start each thread at a random phase offset so pairs sample diverse
    # phase combinations.
    ph_i = rng.integers(0, tables.n_phases[i_arr])
    ph_j = rng.integers(0, tables.n_phases[j_arr])
    left_i = tables.duration[i_arr, ph_i % tables.n_phases[i_arr]].copy()
    left_j = tables.duration[j_arr, ph_j % tables.n_phases[j_arr]].copy()
    for q in range(pair_quanta):
        mi = ph_i % tables.n_phases[i_arr]
        mj = ph_j % tables.n_phases[j_arr]
        comps_i = corun_components_batched(tables, i_arr, mi, j_arr, mj, params)
        comps_j = corun_components_batched(tables, j_arr, mj, i_arr, mi, params)
        comps = np.stack([comps_i, comps_j], axis=1).reshape(2 * p, 4)
        apps = np.stack([i_arr, j_arr], axis=1).reshape(2 * p)
        counters = pmu_counters_batched(
            comps, tables.omega[apps], tables.retire[apps],
            params.quantum_cycles, params, rng,
        )
        pair_counters[:, q] = counters.reshape(p, 2, 5)
        pair_phases[:, q, 0] = mi
        pair_phases[:, q, 1] = mj
        left_i -= 1.0
        left_j -= 1.0
        for ph, left, idx in ((ph_i, left_i, i_arr), (ph_j, left_j, j_arr)):
            (done,) = np.nonzero(left <= 0.0)
            if done.size:
                ph[done] += 1
                lam = tables.duration[idx[done], ph[done] % tables.n_phases[idx[done]]]
                left[done] = np.maximum(1, rng.poisson(lam)).astype(np.float64)

    return ProfilingData(
        app_names=[pr.name for pr in profiles],
        solo_counters=solo_counters,
        solo_phases=solo_phases,
        pair_index=pair_index,
        pair_counters=pair_counters,
        pair_phases=pair_phases,
    )


def _stacks(counters: np.ndarray, method: isc.StackMethod) -> np.ndarray:
    """Repair a (..., 5) counter array into (..., 4) float32 ISC stacks."""
    flat = counters.reshape(-1, 5)
    stacks = isc.build_stack_from_counters(
        flat[:, 0], flat[:, 1], flat[:, 2], flat[:, 3], method
    )
    return stacks.numpy().reshape(counters.shape[:-1] + (4,))


def fit_model(
    data: ProfilingData,
    method: isc.StackMethod,
    max_samples: int = 4000,
    seed: int = 99,
    device=None,
) -> regression.CategoryModel:
    """Fit one SYNPA variant's Eq. 4 model from the profiling campaign.

    Training targets are measured SMT stack fractions scaled by the
    measured slowdown (cpi_smt / cpi_st of the matching solo phase), so
    their sum is the slowdown itself.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    solo_stacks = _stacks(data.solo_counters, method)   # (A, Qs, 4)
    pair_stacks = _stacks(data.pair_counters, method)   # (P, Qp, 2, 4)

    # Per-app, per-phase average ST stack + ST CPI (instruction alignment).
    a = solo_stacks.shape[0]
    max_phase = int(data.solo_phases.max()) + 1
    st_by_phase = np.zeros((a, max_phase, 4))
    cpi_by_phase = np.zeros((a, max_phase))
    solo_cpi = data.solo_counters[:, :, 0] / np.maximum(
        data.solo_counters[:, :, 3], 1e-9
    )
    for ai in range(a):
        for ph in range(max_phase):
            mask = data.solo_phases[ai] == ph
            if mask.any():
                st_by_phase[ai, ph] = solo_stacks[ai, mask].mean(axis=0)
                cpi_by_phase[ai, ph] = solo_cpi[ai, mask].mean()
            else:
                st_by_phase[ai, ph] = solo_stacks[ai].mean(axis=0)
                cpi_by_phase[ai, ph] = solo_cpi[ai].mean()

    smt_cpi = data.pair_counters[:, :, :, 0] / np.maximum(
        data.pair_counters[:, :, :, 3], 1e-9
    )  # (P, Qp, 2)

    apps = np.array(data.pair_index, np.int64)            # (P, 2)
    ph = np.minimum(data.pair_phases, max_phase - 1)      # (P, Qp, 2)
    app_pq = apps[:, None, :]                             # (P, 1, 2)
    st_pq = st_by_phase[app_pq, ph]                       # (P, Qp, 2, 4)
    cpi_pq = cpi_by_phase[app_pq, ph]                     # (P, Qp, 2)
    slow = smt_cpi / np.maximum(cpi_pq, 1e-9)             # (P, Qp, 2)
    ys = (pair_stacks * slow[..., None]).reshape(-1, 4)
    xs_i = st_pq.reshape(-1, 4)
    xs_j = st_pq[:, :, ::-1, :].reshape(-1, 4)

    if xs_i.shape[0] > max_samples:  # paper: a random subset of quanta
        sel = rng.choice(xs_i.shape[0], size=max_samples, replace=False)
        xs_i, xs_j, ys = xs_i[sel], xs_j[sel], ys[sel]

    return regression.fit(xs_i, xs_j, ys, n_categories=method.n_categories,
                          device=device)


def build_all_models(
    machine: SMTMachine,
    methods: Optional[Dict[str, isc.StackMethod]] = None,
    data: Optional[ProfilingData] = None,
    device=None,
    **collect_kw,
) -> Tuple[Dict[str, regression.CategoryModel], ProfilingData]:
    """Fit every SYNPA variant's model off one shared profiling campaign."""
    device = resolve_device(device)
    methods = methods or isc.STACK_METHODS
    if data is None:
        data = collect_profiles(machine, **collect_kw)
    return {name: fit_model(data, m, device=device)
            for name, m in methods.items()}, data
