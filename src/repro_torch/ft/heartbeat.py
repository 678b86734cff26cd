"""Failure detection: heartbeat bookkeeping (numpy-free state machine).

On a real cluster every host POSTs a heartbeat each step; the controller
declares a host dead after ``timeout_s`` of silence and triggers the elastic
replan (``repro_torch.ft.elastic``).  The monitor is a pure state machine over
(host, timestamp) events, so the whole failure->replan->restore path is unit
testable without any real cluster.  The open system's host loop
(``repro_torch.online.sim``) drives it on a quantum-index clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set


@dataclasses.dataclass
class HeartbeatMonitor:
    hosts: List[str]
    timeout_s: float = 30.0

    def __post_init__(self):
        now = time.monotonic()
        self._last: Dict[str, float] = {h: now for h in self.hosts}
        self._dead: Set[str] = set()

    def beat(self, host: str, now: Optional[float] = None) -> None:
        if host not in self._last:
            raise KeyError(
                f"heartbeat from unknown host {host!r}: hosts join through "
                "admit(), a beat never implicitly registers one"
            )
        if host in self._dead:
            return  # must rejoin through admit()
        self._last[host] = time.monotonic() if now is None else now

    def admit(self, host: str, now: Optional[float] = None) -> None:
        """(Re-)admit a host after restart/replacement.

        Always refreshes the timestamp — a rejoining host starts a fresh
        timeout window, it does not inherit its pre-failure silence.
        """
        self._dead.discard(host)
        self._last[host] = time.monotonic() if now is None else now
        if host not in self.hosts:
            self.hosts.append(host)

    def check(self, now: Optional[float] = None) -> Set[str]:
        """Returns the set of *newly* dead hosts as of ``now``."""
        now = time.monotonic() if now is None else now
        newly = set()
        for h, t in self._last.items():
            if h not in self._dead and now - t > self.timeout_s:
                newly.add(h)
        self._dead |= newly
        return newly

    @property
    def alive(self) -> List[str]:
        return [h for h in self.hosts if h not in self._dead]

    @property
    def dead(self) -> Set[str]:
        return set(self._dead)
