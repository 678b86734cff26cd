"""Fault detection and elastic re-planning (numpy and the standard library
only): copies of the reference's ``ft`` package, which the open system's
host event loop drives on a quantum-index clock."""

from repro_torch.ft.elastic import ElasticTopology, replan_after_failure
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.ft.straggler import StragglerDetector, rebalanced_shares

__all__ = [
    "ElasticTopology",
    "replan_after_failure",
    "HeartbeatMonitor",
    "StragglerDetector",
    "rebalanced_shares",
]
