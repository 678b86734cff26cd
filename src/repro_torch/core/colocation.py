"""SYNPA applied to co-locating accelerator jobs, the twin of
``repro.core.colocation``.

The paper's two steps, (1) a bounded-telemetry performance stack per
workload and (2) a pairwise interference model plus a minimum-cost
matching, carry over to jobs sharing an accelerator slice.  The dry-run's
roofline decomposition (``repro_torch.launch.dryrun``) is a job's stack:

    ISC category      accelerator analogue (``launch.roofline``)
    ---------------   -------------------------------------------------
    Dispatch (DI)     compute term        (tensor-core busy fraction)
    Frontend (FE)     collective term     (network-bound fraction)
    Backend  (BE)     memory term         (HBM-bandwidth-bound fraction)
    Horiz. waste (HW) 1 - useful_flops_ratio  (replication/remat waste)

Two jobs on one slice contend for HBM bandwidth (superlinear, like the
paper's LLC/DRAM term) and the network (like the fetch path), while
compute time slices roughly additively.  The machinery is the same: job
stacks -> Eq. 4 model (``pair_score`` on the card) -> matching.  Jobs are
scored against the simulator's ground truth through ``AppProfile``s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.smt.apps import AppProfile, Phase


def job_stack_from_record(record: Dict) -> np.ndarray:
    """Dry-run roofline record -> 4-category stack (DI, FE, BE, HW)."""
    comp = float(record["compute_s"])
    mem = float(record["memory_s"])
    coll = float(record["collective_s"])
    useful = float(record.get("useful_flops_ratio", 1.0))
    waste = comp * max(1.0 - min(useful, 1.0), 0.0)
    di = max(comp - waste, 1e-6)
    total = di + mem + coll + waste
    return np.array([di, coll, mem, waste]) / total


def job_profile(name: str, stack: np.ndarray) -> AppProfile:
    """Translate a job stack into an AppProfile for the simulator.

    DI -> full-dispatch fraction, FE -> frontend stalls (network), BE ->
    backend stalls (HBM), HW -> partial-dispatch cycles.  Memory
    sensitivity scales with how HBM-bound the job is, fetch sensitivity
    with its network share.
    """
    di, fe, be, hw = (float(x) for x in stack)
    phase = Phase(
        x_fe=min(fe, 0.9),
        x_be=min(be, 0.9),
        x_hw=min(hw, 0.9),
        fill=0.5,
        duration=25,
    )
    return AppProfile(
        name=name,
        phases=(phase,),
        omega=0.05,
        retire=0.98,
        mem_sens=min(0.3 + be, 1.0),
        fetch_sens=min(0.3 + fe, 1.0),
    )


@dataclasses.dataclass
class ColocationPlan:
    pairs: List[Tuple[int, int]]
    predicted_cost: float
    job_names: List[str]

    def named_pairs(self) -> List[Tuple[str, str]]:
        return [(self.job_names[i], self.job_names[j]) for i, j in self.pairs]


def plan_colocation(records: Sequence[Dict], model, matcher: str = "auto",
                    device=None) -> ColocationPlan:
    """Pair 2N jobs onto N shared slices with the SYNPA pipeline.

    records: dry-run roofline records (the jobs' stacks).
    model:   a fitted Eq. 4 ``CategoryModel``; its coefficients move to
             ``device`` (``cuda`` unless told otherwise).

    The stacks are scored on ``device`` by ``regression.pair_cost_matrix``
    (one ``pair_score`` launch on a GPU), the cost comes to the host once,
    and the host matcher pairs them.
    """
    from repro_torch.core import matching, regression

    dev = resolve_device(device)
    stacks = np.stack([job_stack_from_record(r) for r in records])
    st = torch.as_tensor(stacks, dtype=torch.float32).to(dev)
    cost = regression.pair_cost_matrix(model.to(dev), st).cpu().numpy()
    pairs = matching.min_cost_pairs(cost, method=matcher)
    return ColocationPlan(
        pairs=pairs,
        predicted_cost=matching.matching_cost(cost, pairs),
        job_names=[f"{r['arch']}/{r['shape']}" for r in records],
    )


def evaluate_placement(
    records: Sequence[Dict],
    pairs: Sequence[Tuple[int, int]],
    params=None,
) -> float:
    """Ground-truth mean slowdown of a placement (simulator oracle)."""
    from repro_torch.smt.machine import MachineParams, true_slowdown

    params = params or MachineParams()
    profiles = [
        job_profile(f"{r['arch']}/{r['shape']}", job_stack_from_record(r))
        for r in records
    ]
    total = 0.0
    for i, j in pairs:
        total += true_slowdown(profiles[i].phase(0), profiles[i],
                               profiles[j].phase(0), params)
        total += true_slowdown(profiles[j].phase(0), profiles[j],
                               profiles[i].phase(0), params)
    return total / (2 * len(pairs))
