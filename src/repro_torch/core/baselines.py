"""Baseline thread-to-core allocation policies the paper compares against
(numpy; the port's copies of ``repro.core.baselines``, drawing the same
numbers from the same policy generator).

* :class:`LinuxScheduler`  — models the CFS behaviour the paper measures
  against: interference-oblivious, load-balanced (all cores get two threads),
  with occasional migrations between cores.  It neither reads performance
  counters nor knows about synergy.
* :class:`HySchedScheduler` — the state-of-the-art heuristic policy (paper
  §7.3.1, adapted from Intel to the ARM PMU exactly as the paper describes):
  four top-down categories (Retiring, Bad Speculation, Frontend, Backend),
  dominant-category pairing, IPC balancing as the fallback.
* :class:`RandomStaticScheduler` — a random pairing chosen once and pinned.
* :class:`OracleScheduler` — cheats: reads the machine's ground-truth
  interference and matches optimally.  Upper bound for any T2C policy.
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core import matching
from repro_torch.core.synpa import Pair, Scheduler


class LinuxScheduler(Scheduler):
    """CFS-like: fair, oblivious; migrates threads occasionally."""

    name = "linux"

    def __init__(self, p_migrate: float = 0.03):
        self.p_migrate = p_migrate

    def schedule(self, quantum, samples, prev_pairs):
        if not prev_pairs:
            return self._random_pairs()
        pairs = [list(p) for p in prev_pairs]
        # Each rebalance tick, swap one thread between two random cores.
        if self.rng.random() < self.p_migrate and len(pairs) >= 2:
            a, b = self.rng.choice(len(pairs), size=2, replace=False)
            sa = int(self.rng.integers(2))
            sb = int(self.rng.integers(2))
            pairs[a][sa], pairs[b][sb] = pairs[b][sb], pairs[a][sa]
        return [tuple(p) for p in pairs]


class RandomStaticScheduler(Scheduler):
    """Random pairing fixed for the whole execution."""

    name = "random-static"

    def schedule(self, quantum, samples, prev_pairs):
        if not prev_pairs:
            return self._random_pairs()
        return prev_pairs


class HySchedScheduler(Scheduler):
    """Hy-Sched [8] adapted to the ARM ThunderX2 PMU (paper §7.3.1).

    Categories per application (dispatch-stage events, width 4):
        Retiring        = INST_RETIRED / (4 * CPU_CYCLES)
        Bad Speculation = (INST_SPEC - INST_RETIRED) / (4 * CPU_CYCLES)
        Frontend-Bound  = STALL_FRONTEND / CPU_CYCLES
        Backend-Bound   = STALL_BACKEND / CPU_CYCLES
    Each app is classified by its largest category.  First option: pair apps
    of *different* categories.  When impossible, balance IPC (pair highest
    with lowest).
    """

    name = "hy-sched"

    def schedule(self, quantum, samples, prev_pairs):
        if not self._have_samples(samples):
            return self._random_pairs()
        c = self._counters_array(samples)
        cycles = np.maximum(c[:, 0], 1e-9)
        retiring = c[:, 4] / (4.0 * cycles)
        badspec = np.maximum(c[:, 3] - c[:, 4], 0.0) / (4.0 * cycles)
        frontend = c[:, 1] / cycles
        backend = c[:, 2] / cycles
        cats = np.stack([retiring, badspec, frontend, backend], axis=1)
        klass = np.argmax(cats, axis=1)
        ipc = c[:, 4] / cycles

        remaining = sorted(range(self.n_apps), key=lambda i: -ipc[i])
        pairs: List[Pair] = []
        while remaining:
            # Take an app from the most populated class.
            counts = {}
            for i in remaining:
                counts.setdefault(klass[i], []).append(i)
            big = max(counts, key=lambda k: len(counts[k]))
            a = counts[big][0]
            others = [i for i in remaining if klass[i] != klass[a]]
            if others:
                # Partner from a different category (lowest IPC first to
                # balance the core's pressure).
                b = min(others, key=lambda i: ipc[i])
            else:
                # All the same category: IPC balancing (highest with lowest).
                rest = [i for i in remaining if i != a]
                b = min(rest, key=lambda i: ipc[i])
            remaining.remove(a)
            remaining.remove(b)
            pairs.append((a, b))
        return pairs


class OracleScheduler(Scheduler):
    """Ground-truth optimal pairing (cheating upper bound, not in the paper)."""

    name = "oracle"

    def schedule(self, quantum, samples, prev_pairs):
        # Vectorised engine: the machine exposes the ground-truth cost matrix
        # directly (one batched computation, scales to cluster-size N).
        oracle = getattr(self.machine, "oracle_cost_matrix", None)
        sym = oracle() if oracle is not None else None
        if sym is None:
            states = getattr(self.machine, "_active_states", None)
            if states is None:
                return self._random_pairs()
            from repro_torch.smt.machine import true_slowdown  # late import, no cycle

            n = self.n_apps
            cost = np.zeros((n, n))
            for i in range(n):
                for j in range(n):
                    if i != j:
                        cost[i, j] = true_slowdown(
                            states[i].phase(), states[i].profile,
                            states[j].phase(), self.machine.params,
                        )
            sym = cost + cost.T
            np.fill_diagonal(sym, 1e9)
        return matching.min_cost_pairs(sym)
