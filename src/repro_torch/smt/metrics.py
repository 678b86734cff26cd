"""Open-system metrics (numpy): per-job records and their distributions.

The port's own copy of what the open system needs from
``repro.smt.metrics``.  In the open system applications arrive, run to an
instruction target and depart, so the closed-system headline (mean
turnaround of a fixed workload) is replaced by per-*job* records:
turnaround, slowdown (turnaround over solo time, queueing included), queue
depth over time, and the policy's own cost per quantum.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class JobRecord:
    """One completed (or still-running) job of the open system."""

    job_id: int
    app_name: str
    arrive_q: int                   # quantum the job entered the system
    admit_q: int                    # quantum it got a hardware context
    finish_q: float                 # fractional quantum it completed (inf if not)
    target: float                   # retired-instruction target
    solo_s: float                   # solo execution time for the same target
    retries: int = 0                # fault evictions survived (online.faults)

    def turnaround_s(self, quantum_s: float) -> float:
        return (self.finish_q - self.arrive_q) * quantum_s

    def wait_s(self, quantum_s: float) -> float:
        return (self.admit_q - self.arrive_q) * quantum_s

    def slowdown(self, quantum_s: float) -> float:
        """Observed slowdown vs running alone the moment it arrived (>= 1
        up to counter noise); includes time spent queued for a context."""
        return self.turnaround_s(quantum_s) / max(self.solo_s, 1e-12)


def slowdown_ccdf(
    slowdowns: Sequence[float], grid: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Complementary CDF of per-job slowdowns (paper Fig. 7 shape).

    Returns ``(grid, ccdf)`` with ``ccdf[k] = P[slowdown > grid[k]]``.
    """
    s = np.asarray(list(slowdowns), dtype=np.float64)
    if grid is None:
        hi = float(s.max()) if s.size else 2.0
        grid = np.linspace(1.0, max(hi, 1.0 + 1e-6), 64)
    grid = np.asarray(grid, dtype=np.float64)
    if s.size == 0:
        return grid, np.zeros_like(grid)
    ccdf = (s[None, :] > grid[:, None]).mean(axis=1)
    return grid, ccdf


@dataclasses.dataclass
class OnlineStats:
    """Per-run metrics of one open-system (``ClusterSim``) execution."""

    policy_name: str
    quantum_s: float
    quanta: int
    completed: List[JobRecord]
    n_arrived: int
    n_admitted: int
    queue_depth: np.ndarray         # (Q,) jobs waiting for a context
    active: np.ndarray              # (Q,) jobs holding a context
    policy_s: np.ndarray            # (Q,) policy wall-time per quantum
    solo_quanta: np.ndarray         # (Q,) apps running with an idle context
    #: Per-quantum traffic timelines, rebuilt from the flat job logs
    #: (:meth:`from_device_logs`).
    arrivals: Optional[np.ndarray] = None     # (Q,) jobs arrived
    admissions: Optional[np.ndarray] = None   # (Q,) jobs admitted
    departures: Optional[np.ndarray] = None   # (Q,) jobs departed
    #: Device telemetry ring (``repro_torch.obs.telemetry.TelemetryLog``)
    #: when the run was launched with ``telemetry=True``; None otherwise.
    telemetry: Optional[object] = None
    #: Per-application ring (``AppTelemetryLog``) when launched with
    #: ``app_telemetry=True``; None otherwise.
    app_telemetry: Optional[object] = None
    #: Fault timelines and scalars (``repro_torch.online.faults``); all
    #: None / 0 when the run had no FaultProfile.  failures/recoveries/
    #: straggling are fault-schedule data; evictions/requeues are counted
    #: by the engine.
    failures: Optional[np.ndarray] = None     # (Q,) cores newly down
    recoveries: Optional[np.ndarray] = None   # (Q,) cores newly up
    evictions: Optional[np.ndarray] = None    # (Q,) jobs evicted
    requeues: Optional[np.ndarray] = None     # (Q,) retry re-admissions
    straggling: Optional[np.ndarray] = None   # (Q,) degraded up cores
    n_dropped: int = 0              # jobs that exhausted max_retries
    n_retry_waiting: int = 0        # jobs in retry backoff at horizon end
    n_in_flight: int = 0            # jobs still on a context at horizon end

    @property
    def n_evicted(self) -> int:
        return int(self.evictions.sum()) if self.evictions is not None else 0

    @property
    def n_requeued(self) -> int:
        return int(self.requeues.sum()) if self.requeues is not None else 0

    @property
    def has_faults(self) -> bool:
        return self.evictions is not None

    def retry_ccdf(self) -> Tuple[np.ndarray, np.ndarray]:
        """CCDF of retries over completed jobs: ``P[retries > k]`` for
        k = 0..max observed (the requeue tail of a fault profile)."""
        r = np.array([j.retries for j in self.completed], np.int64)
        hi = int(r.max()) if r.size else 0
        grid = np.arange(hi + 1, dtype=np.float64)
        if r.size == 0:
            return grid, np.zeros_like(grid)
        return grid, (r[None, :] > grid[:, None]).mean(axis=1)

    # ------------------------------------------------------------- scalars
    @property
    def n_completed(self) -> int:
        return len(self.completed)

    @property
    def slowdowns(self) -> np.ndarray:
        return np.array(
            [j.slowdown(self.quantum_s) for j in self.completed]
        )

    @property
    def mean_turnaround_s(self) -> float:
        if not self.completed:
            return math.nan
        return float(
            np.mean([j.turnaround_s(self.quantum_s) for j in self.completed])
        )

    @property
    def mean_slowdown(self) -> float:
        s = self.slowdowns
        return float(s.mean()) if s.size else math.nan

    def slowdown_percentile(self, p: float) -> float:
        s = self.slowdowns
        return float(np.percentile(s, p)) if s.size else math.nan

    def ccdf(self, grid: Optional[np.ndarray] = None):
        return slowdown_ccdf(self.slowdowns, grid)

    @property
    def throughput_jobs_per_s(self) -> float:
        return self.n_completed / max(self.quanta * self.quantum_s, 1e-12)

    @property
    def mean_queue_depth(self) -> float:
        return float(self.queue_depth.mean()) if self.queue_depth.size else 0.0

    @property
    def policy_us_per_quantum(self) -> float:
        return float(self.policy_s.mean() * 1e6) if self.policy_s.size else 0.0

    @property
    def policy_us_per_quantum_median(self) -> float:
        return float(np.median(self.policy_s) * 1e6) if self.policy_s.size \
            else 0.0

    def timelines(self) -> Dict[str, np.ndarray]:
        """Named per-quantum series of the run: ``queue_depth``, ``active``
        and ``solo_quanta``, every traffic and fault series the run
        recorded, and every telemetry field under a ``tlm_`` prefix when
        the run recorded the ring."""
        out: Dict[str, np.ndarray] = {
            "queue_depth": np.asarray(self.queue_depth),
            "active": np.asarray(self.active),
            "solo_quanta": np.asarray(self.solo_quanta),
        }
        for name in ("arrivals", "admissions", "departures", "failures",
                     "recoveries", "evictions", "requeues", "straggling"):
            v = getattr(self, name)
            if v is not None:
                out[name] = np.asarray(v)
        if self.telemetry is not None:
            for f in self.telemetry.fields:
                out[f"tlm_{f}"] = self.telemetry.timeline(f)
        return out

    # ------------------------------------------------------- device logs
    @classmethod
    def from_device_logs(
        cls,
        policy_name: str,
        quantum_s: float,
        quanta: int,
        app_names: Sequence[str],
        arrive_q: np.ndarray,
        admit_q: np.ndarray,
        finish_q: np.ndarray,
        targets: np.ndarray,
        solo_s: np.ndarray,
        queue_depth: np.ndarray,
        active: np.ndarray,
        policy_s: np.ndarray,
        solo_quanta: np.ndarray,
        retries: Optional[np.ndarray] = None,
    ) -> "OnlineStats":
        """Rebuild the per-run stats from a device run's flat job logs:
        ``admit_q`` (-1 = never admitted) and ``finish_q`` (inf = still
        running), fetched once at the end of the run.  The completed list
        is ordered by (finish quantum, job id)."""
        records = [
            JobRecord(
                job_id=j,
                app_name=str(app_names[j]),
                arrive_q=int(arrive_q[j]),
                admit_q=int(admit_q[j]),
                finish_q=float(finish_q[j]),
                target=float(targets[j]),
                solo_s=float(solo_s[j]),
                retries=int(retries[j]) if retries is not None else 0,
            )
            for j in range(len(arrive_q))
        ]
        completed = sorted(
            (r for r in records if math.isfinite(r.finish_q)),
            key=lambda r: (r.finish_q, r.job_id),
        )
        # One bincount per series.  A departure at fractional quantum f
        # frees its context at the end of quantum floor(f).
        arrive = np.asarray(arrive_q, np.int64)
        admit = np.asarray(admit_q, np.int64)
        finish = np.asarray(finish_q, np.float64)
        arrivals = np.bincount(
            np.clip(arrive[arrive >= 0], 0, quanta - 1), minlength=quanta
        ).astype(np.float64) if quanta else np.zeros(0)
        admissions = np.bincount(
            np.clip(admit[admit >= 0], 0, quanta - 1), minlength=quanta
        ).astype(np.float64) if quanta else np.zeros(0)
        fin = np.floor(finish[np.isfinite(finish)]).astype(np.int64)
        departures = np.bincount(
            np.clip(fin, 0, quanta - 1), minlength=quanta
        ).astype(np.float64) if quanta else np.zeros(0)
        return cls(
            policy_name=policy_name,
            quantum_s=quantum_s,
            quanta=quanta,
            completed=completed,
            n_arrived=len(records),
            n_admitted=int(sum(1 for r in records if r.admit_q >= 0)),
            queue_depth=np.asarray(queue_depth, np.float64),
            active=np.asarray(active, np.float64),
            policy_s=np.asarray(policy_s, np.float64),
            solo_quanta=np.asarray(solo_quanta, np.float64),
            arrivals=arrivals,
            admissions=admissions,
            departures=departures,
        )

    def summary(self) -> Dict[str, float]:
        """Flat dict of the run's headline numbers; the fault scalars only
        when the run carried a fault profile."""
        out = {
            "n_arrived": self.n_arrived,
            "n_completed": self.n_completed,
            "mean_turnaround_s": self.mean_turnaround_s,
            "mean_slowdown": self.mean_slowdown,
            "p95_slowdown": self.slowdown_percentile(95.0),
            "p99_slowdown": self.slowdown_percentile(99.0),
            "throughput_jobs_per_s": self.throughput_jobs_per_s,
            "mean_queue_depth": self.mean_queue_depth,
            "policy_us_per_quantum": self.policy_us_per_quantum,
            "policy_us_per_quantum_median": self.policy_us_per_quantum_median,
        }
        if self.has_faults:
            out.update({
                "n_evicted": float(self.n_evicted),
                "n_requeued": float(self.n_requeued),
                "n_dropped": float(self.n_dropped),
                "n_retry_waiting": float(self.n_retry_waiting),
                "n_in_flight": float(self.n_in_flight),
                "total_failures": float(self.failures.sum()),
                "total_recoveries": float(self.recoveries.sum()),
                "straggling_core_quanta": float(self.straggling.sum()),
                "mean_retries_completed": float(
                    np.mean([j.retries for j in self.completed])
                ) if self.completed else 0.0,
            })
        return out
