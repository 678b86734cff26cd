"""Queue-aware admission: the synergy placement tier of ``ClusterSim``.

FIFO admission places a dequeued job on the lowest free context and tells
the policy nothing about it: until its first counters land, a newcomer
scores with the uniform ST placeholder.  ``SynergyAdmission`` packages what
a cluster knows of the job types it runs:

* per pool application, the measured noiseless **solo ISC stack** under the
  policy's stack method (:func:`repro_torch.smt.workloads.solo_stack`);
* the **Eq. 4 predicted pair-cost matrix** over those stacks, computed by
  the ``pair_score`` kernel on the model's device
  (:func:`repro_torch.core.regression.pair_cost_matrix`).

At admission it (a) *places* the dequeued job (FIFO order kept) on the
free context whose core-resident co-runner has the best predicted pair
score, a context on an empty core scoring the expected pool cost, and (b)
hands the policy the newcomer's profiled solo stack as an **ST hint**.
The open-system engine (:mod:`repro_torch.online.device_sim`) runs the
same placement rule on the device with these tables.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import isc, regression


class SynergyAdmission:
    """Profile-informed placement + ST seeding for dequeued jobs.

    machine/pool: the simulator's machine and application pool;
    method:       the stack method the *policy* uses: hints must live in
                  the same stack space as the allocator's estimates;
    model:        the fitted Eq. 4 model used for pair scoring; the pool
                  cost is computed on its device;
    quanta:       solo-profiling horizon per pool application (noiseless).
    """

    def __init__(self, machine, pool, method: isc.StackMethod,
                 model: regression.CategoryModel, quanta: int = 40):
        from repro_torch.smt.workloads import solo_stack

        self.method = method
        self.stacks = np.stack([
            np.asarray(solo_stack(machine, p, method, quanta=quanta),
                       np.float32)
            for p in pool
        ])
        cost = regression.pair_cost_matrix(
            model, torch.as_tensor(self.stacks, device=model.coeffs.device))
        self.pool_cost = cost.cpu().numpy().astype(np.float64)
        # Expected pairing cost of each job type against a uniform random
        # co-runner: the placement score of a context on an empty core.
        off = ~np.eye(len(pool), dtype=bool)
        self.mean_cost = np.array([
            self.pool_cost[k][off[k]].mean() for k in range(len(pool))
        ])

    def place(self, pid: int, free_slots: Sequence[int],
              app_id: np.ndarray) -> int:
        """Free slot with the best predicted co-runner for pool app ``pid``.

        ``app_id`` maps slots to pool indices (-1 = empty); a free slot's
        co-runner is the resident of the other context of its core
        (``slot ^ 1``).  Ties break to the lowest slot (clone pool apps
        predict identical pair costs), and a slot whose core-mate is empty
        scores the expected pool cost.
        """
        free = np.sort(np.asarray(list(free_slots), dtype=np.int64))
        assert free.size, "no free slot to place on"
        mate = app_id[free ^ 1]
        cost = np.where(
            mate >= 0,
            self.pool_cost[pid, np.maximum(mate, 0)],
            self.mean_cost[pid],
        )
        return int(free[int(np.argmin(cost))])

    def hint(self, pid: int) -> np.ndarray:
        """Profiled solo ST stack of pool app ``pid`` (the policy hint)."""
        return self.stacks[pid]
