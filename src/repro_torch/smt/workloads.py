"""Workload construction — the paper's §6.2 evaluation methodology (numpy).

Applications are classified from their *measured* solo ISC3 stacks (gap
assigned to Backend, GT100 normalised):

    Frontend-Bound  FE fraction > 0.35
    Backend-Bound   BE fraction > 0.65
    Others          the rest

35 workloads of 8 applications each are composed from the 24-app pool:

    be0..be14   5 or 6 Backend-Bound + rest Others
    fe0..fe4    5 or 6 Frontend-Bound + rest Others
    fb0..fb14   4 Backend-Bound + 4 Frontend-Bound

:func:`scaled_workload` makes the synthetic N-app populations of the
cluster-scale runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core import isc
from repro_torch.smt.apps import AppProfile, pool_profiles, profiles_by_name
from repro_torch.smt.machine import SMTMachine

FE_THRESHOLD = 0.35
BE_THRESHOLD = 0.65

_CLASSIFY_METHOD = isc.StackMethod(isc.LT100Method.ISC3_A_BE,
                                   isc.GT100Method.ISC3_N)


def solo_stack(machine: SMTMachine, profile: AppProfile,
               method: isc.StackMethod = _CLASSIFY_METHOD,
               quanta: int = 40) -> np.ndarray:
    """Average measured solo ISC stack (noiseless) for characterisation."""
    samples, _ = machine.run_solo(profile, quanta, noisy=False)
    counters = np.array([s.as_tuple() for s in samples])
    stacks = isc.build_stack_from_counters(
        counters[:, 0], counters[:, 1], counters[:, 2], counters[:, 3], method
    )
    return np.asarray(stacks).mean(axis=0)


def classify(machine: SMTMachine,
             profiles: Sequence[AppProfile] = None) -> Dict[str, str]:
    """Group every app into Frontend-Bound / Backend-Bound / Others."""
    profiles = profiles if profiles is not None else pool_profiles()
    groups = {}
    for p in profiles:
        st = solo_stack(machine, p)
        if st[isc.CAT_FE] > FE_THRESHOLD:
            groups[p.name] = "frontend"
        elif st[isc.CAT_BE] > BE_THRESHOLD:
            groups[p.name] = "backend"
        else:
            groups[p.name] = "others"
    return groups


def make_workloads(machine: SMTMachine, seed: int = 2024,
                   apps_per_workload: int = 8) -> Dict[str, List[str]]:
    """Build the 35 named workloads (15 be / 5 fe / 15 fb)."""
    rng = np.random.default_rng(seed)
    groups = classify(machine)
    fe_pool = sorted(n for n, g in groups.items() if g == "frontend")
    be_pool = sorted(n for n, g in groups.items() if g == "backend")
    ot_pool = sorted(n for n, g in groups.items() if g == "others")
    assert len(fe_pool) >= 6, f"frontend pool too small: {fe_pool}"
    assert len(be_pool) >= 6, f"backend pool too small: {be_pool}"
    assert len(ot_pool) >= 3, f"others pool too small: {ot_pool}"

    def sample(pool: List[str], k: int) -> List[str]:
        return list(rng.choice(pool, size=k, replace=False))

    workloads: Dict[str, List[str]] = {}
    for w in range(15):  # Backend-intensive
        k = 5 + int(rng.integers(2))
        workloads[f"be{w}"] = sample(be_pool, k) + sample(ot_pool, apps_per_workload - k)
    for w in range(5):   # Frontend-intensive
        k = 5 + int(rng.integers(2))
        workloads[f"fe{w}"] = sample(fe_pool, k) + sample(ot_pool, apps_per_workload - k)
    for w in range(15):  # Mixed
        workloads[f"fb{w}"] = sample(be_pool, 4) + sample(fe_pool, 4)
    return workloads


def workload_profiles(names: Sequence[str]) -> List[AppProfile]:
    by_name = profiles_by_name()
    return [by_name[n] for n in names]


def scaled_workload(n_apps: int, seed: int = 0) -> List[AppProfile]:
    """Synthetic N-app workload for cluster-scale runs (N past the paper's 8).

    Samples the 24-app pool with replacement and gives every clone a unique
    name (``<app>@<slot>``) so per-profile caches keyed by name stay correct.
    """
    assert n_apps % 2 == 0, "need an even number of applications"
    rng = np.random.default_rng(seed)
    pool = pool_profiles()
    picks = rng.integers(0, len(pool), size=n_apps)
    return [
        dataclasses.replace(pool[k], name=f"{pool[k].name}@{i}")
        for i, k in enumerate(picks)
    ]
