"""Arrival processes for the open-system cluster simulation (numpy).

The port's own copy of ``repro.online.arrivals``: the same draws from the
same generator, so a run here faces the reference's traffic job for job.

The paper's §6.2 evaluation is a closed system: a fixed workload runs until
every application reaches its instruction target.  The online subsystem
opens it up: applications *arrive* over time (Poisson traffic or an explicit
trace), run to their target and depart.  An arrival process maps a quantum
index to the list of pool applications entering the system in that quantum;
all randomness comes from the generator the simulator passes in, so a run
is reproducible from its seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


class ArrivalProcess:
    """Base interface: which pool applications arrive in quantum ``q``."""

    def draw(self, q: int, rng: np.random.Generator) -> List[int]:
        """Pool indices of the applications arriving during quantum ``q``."""
        raise NotImplementedError


@dataclasses.dataclass
class PoissonArrivals(ArrivalProcess):
    """Open-system traffic: ``Poisson(rate)`` arrivals per quantum.

    ``rate`` is the expected number of arriving applications per 100 ms
    quantum; each arrival samples the pool uniformly (``weights`` overrides
    with per-app probabilities).  ``burst_every``/``burst_size`` optionally
    superimpose a deterministic flash crowd, which is what pushes a policy's
    queueing behaviour into the regime the slowdown CCDF cares about.
    """

    rate: float
    n_pool: int
    weights: Sequence[float] = None
    burst_every: int = 0
    burst_size: int = 0

    def draw(self, q: int, rng: np.random.Generator) -> List[int]:
        k = int(rng.poisson(self.rate))
        if self.burst_every and q > 0 and q % self.burst_every == 0:
            k += self.burst_size
        if k == 0:
            return []
        p = None
        if self.weights is not None:
            w = np.asarray(self.weights, dtype=np.float64)
            p = w / w.sum()
        return [int(x) for x in rng.choice(self.n_pool, size=k, p=p)]


@dataclasses.dataclass
class TraceArrivals(ArrivalProcess):
    """Deterministic trace: explicit ``(quantum, pool_index)`` events.

    Used by tests (seeded churn sequences with known arrival points) and for
    replaying recorded traffic.  Events need not be sorted.
    """

    events: Sequence[Tuple[int, int]]

    def __post_init__(self):
        by_q: Dict[int, List[int]] = {}
        for quantum, pool_idx in self.events:
            by_q.setdefault(int(quantum), []).append(int(pool_idx))
        self._by_q = by_q

    def draw(self, q: int, rng: np.random.Generator) -> List[int]:
        return list(self._by_q.get(q, []))


def presample(
    process: ArrivalProcess, n_quanta: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Materialise an arrival process into flat ``(arrive_q, pool_idx)`` arrays.

    Draws quantum by quantum from ``rng`` — exactly the order the host
    ``ClusterSim`` event loop consumes its arrival stream — so a device-
    resident run (``repro_torch.online.device_sim``) pre-sampling with the same
    generator faces *bit-identical traffic* to the host run.  ``arrive_q``
    is non-decreasing by construction: arrivals are data, not compute, so
    the device engine ships them once with the initial carry instead of
    drawing in-graph.
    """
    qs: List[int] = []
    pids: List[int] = []
    for q in range(n_quanta):
        for pid in process.draw(q, rng):
            qs.append(q)
            pids.append(int(pid))
    return np.asarray(qs, np.int64), np.asarray(pids, np.int64)


@dataclasses.dataclass
class InitialBatch(ArrivalProcess):
    """A fixed population arriving at quantum 0 and nothing afterwards.

    Composing this with zero later arrivals turns the open system back into
    the paper's closed §6.2 race — the degenerate case the exactness tests
    (streaming allocator vs cold SYNPA) are phrased in.
    """

    pool_indices: Sequence[int]

    def draw(self, q: int, rng: np.random.Generator) -> List[int]:
        return [int(x) for x in self.pool_indices] if q == 0 else []
