"""Elastic re-meshing: recompute the (pod, data, model) topology after a
failure and produce the new mesh + sharding plan + batch scaling.

Policy (standard large-fleet practice):
* the model axis is sacred — losing part of a model-parallel group kills the
  whole group (its weights shards are gone); surviving *complete* groups are
  re-formed into a smaller data axis,
* the global batch is kept constant by raising per-group microbatch steps
  (gradient accumulation) when the data axis shrinks,
* training resumes from the newest valid checkpoint into the new topology
  (checkpoints are topology-agnostic: full unsharded trees).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ElasticTopology:
    """A concrete runnable topology for the surviving fleet."""

    n_pods: int
    data_parallel: int          # per-pod data-parallel groups
    model_parallel: int
    grad_accum_steps: int       # microbatch multiplier keeping global batch
    lost_hosts: Tuple[str, ...]

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        if self.n_pods > 1:
            return (self.n_pods, self.data_parallel, self.model_parallel)
        return (self.data_parallel, self.model_parallel)

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        if self.n_pods > 1:
            return ("pod", "data", "model")
        return ("data", "model")

    @property
    def n_devices(self) -> int:
        return self.n_pods * self.data_parallel * self.model_parallel


def replan_after_failure(
    hosts_per_group: Dict[str, Sequence[str]],
    dead_hosts: Sequence[str],
    model_parallel: int,
    base_data_parallel: int,
    base_grad_accum: int = 1,
    n_pods: int = 1,
) -> ElasticTopology:
    """Drop every model-parallel group touching a dead host; rebuild.

    hosts_per_group: group id -> hosts backing that model-parallel group.
    Raises if fewer than one group survives (nothing runnable).
    """
    dead = set(dead_hosts)
    surviving = [g for g, hs in hosts_per_group.items()
                 if not (set(hs) & dead)]
    if not surviving:
        raise RuntimeError("no complete model-parallel group survives")
    new_dp_total = len(surviving)
    # keep the global batch: grad_accum scales by the shrink factor (ceil)
    shrink = (base_data_parallel * n_pods) / new_dp_total
    accum = max(base_grad_accum, int(math.ceil(base_grad_accum * shrink)))
    # collapse to single-pod topology when a whole pod is gone
    pods = 1 if new_dp_total < base_data_parallel * n_pods and n_pods > 1 \
        else n_pods
    dp_per_pod = new_dp_total // pods
    return ElasticTopology(
        n_pods=pods,
        data_parallel=dp_per_pod,
        model_parallel=model_parallel,
        grad_accum_steps=accum,
        lost_hosts=tuple(sorted(dead)),
    )
