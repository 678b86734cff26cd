"""Synthetic cluster-scale workloads (numpy)."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.smt.apps import AppProfile, pool_profiles


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
