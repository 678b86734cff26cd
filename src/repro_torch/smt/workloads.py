"""Synthetic cluster-scale workloads and solo stacks (numpy)."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core import isc
from repro_torch.smt.apps import AppProfile, pool_profiles
from repro_torch.smt.machine import SMTMachine

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
