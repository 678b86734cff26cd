"""Straggler detection and mitigation for synchronous data-parallel steps.

In a synchronous data-parallel step the fleet moves at the slowest host's pace.  The
detector keeps a per-host EWMA of step times and flags hosts whose latency
exceeds ``threshold`` x the fleet median for ``patience`` consecutive steps.
Mitigations (applied by the controller):

* ``rebalance`` — shrink the straggler's microbatch share (work stealing via
  the deterministic data pipeline: shard boundaries are pure functions of
  (step, host), so re-assignment needs no data movement);
* ``evict``     — treat the host as failed: heartbeat-style elastic replan
  (``repro_torch.ft.elastic``) and restore-from-checkpoint into the new topology.

The open system's host loop (``repro_torch.online.sim``) feeds it one
"step time" per core a quantum (the inverse of the core's speed).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerDetector:
    hosts: List[str]
    alpha: float = 0.2          # EWMA coefficient
    threshold: float = 1.5      # x median latency
    patience: int = 5           # consecutive flagged steps before action

    def __post_init__(self):
        self._ewma: Dict[str, float] = {}
        self._strikes: Dict[str, int] = {h: 0 for h in self.hosts}

    def observe(self, step_times: Dict[str, float]) -> List[str]:
        """Feed one step's per-host wall times; returns hosts to mitigate."""
        for h, t in step_times.items():
            prev = self._ewma.get(h, t)
            self._ewma[h] = (1 - self.alpha) * prev + self.alpha * t
        med = float(np.median(list(self._ewma.values())))
        actionable = []
        for h in self.hosts:
            if h not in self._ewma:
                continue
            if self._ewma[h] > self.threshold * med:
                self._strikes[h] += 1
            else:
                self._strikes[h] = 0
            if self._strikes[h] >= self.patience:
                actionable.append(h)
        return actionable

    def ewma(self, host: str) -> Optional[float]:
        return self._ewma.get(host)


def rebalanced_shares(hosts: List[str], ewma: Dict[str, float],
                      total_microbatches: int) -> Dict[str, int]:
    """Microbatch shares inversely proportional to per-host step time.

    Every host keeps >= 1 microbatch; the global batch is preserved.
    """
    speeds = np.array([1.0 / max(ewma.get(h, 1.0), 1e-9) for h in hosts])
    raw = speeds / speeds.sum() * total_microbatches
    shares = np.maximum(np.floor(raw).astype(int), 1)
    # distribute the remainder to the fastest hosts
    while shares.sum() < total_microbatches:
        shares[int(np.argmax(raw - shares))] += 1
    while shares.sum() > total_microbatches:
        idx = int(np.argmax(shares))
        if shares[idx] <= 1:
            break
        shares[idx] -= 1
    return {h: int(s) for h, s in zip(hosts, shares)}
