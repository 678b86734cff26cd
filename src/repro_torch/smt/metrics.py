"""Evaluation metrics (numpy): the port's copy of ``repro.smt.metrics``.

Closed workloads (§6.2): turnaround time, IPC geomean and repeat-run
averaging.  The paper repeats every workload >= 10 times, computes the
coefficient of variation of the execution times, discards outliers and
averages the rest; :func:`run_repeated` does the same at a scaled repeat
count.

Open system: applications arrive, run to an instruction target and
depart, so the closed-system headline is replaced by per-*job* records:
turnaround, slowdown (turnaround over solo time, queueing included), queue
depth over time, and the policy's own cost per quantum; :class:`GridStats`
aggregates runs over seeds with bootstrap intervals.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

@dataclasses.dataclass
class PolicyWorkloadStats:
    """Outlier-filtered averages over repeated runs of one (policy, workload)."""

    avg_turnaround_s: float
    makespan_s: float
    ipc_geomean: float
    n_runs: int
    n_kept: int
    cv: float


def robust_mean(values: np.ndarray, trim_sigma: float = 1.5) -> np.ndarray:
    """Discard runs whose headline value deviates > trim_sigma stddevs.

    The paper's filter ("over mu +- 0.05 x sigma/mu") is stated in relative
    terms; we use the standard sigma-clipping equivalent and record the CV.
    """
    mu, sd = values.mean(), values.std()
    if sd == 0:
        return np.ones(len(values), dtype=bool)
    keep = np.abs(values - mu) <= trim_sigma * sd
    if not keep.any():
        keep[:] = True
    return keep


def run_repeated(
    machine,
    profiles,
    policy_factory: Callable[[], object],
    repeats: int = 5,
    base_seed: int = 0,
) -> PolicyWorkloadStats:
    """Run one workload ``repeats`` times under a fresh policy instance."""
    tts, mks, ipcs = [], [], []
    for r in range(repeats):
        res = machine.run_workload(
            profiles, policy_factory(), seed=base_seed + 1000 * r
        )
        tts.append(res.avg_turnaround_s)
        mks.append(res.makespan_s)
        ipcs.append(res.ipc_geomean)
    tts = np.array(tts); mks = np.array(mks); ipcs = np.array(ipcs)
    keep = robust_mean(mks)
    cv = float(mks.std() / max(mks.mean(), 1e-12))
    return PolicyWorkloadStats(
        avg_turnaround_s=float(tts[keep].mean()),
        makespan_s=float(mks[keep].mean()),
        ipc_geomean=float(ipcs[keep].mean()),
        n_runs=repeats,
        n_kept=int(keep.sum()),
        cv=cv,
    )


def speedup(baseline: float, policy: float) -> float:
    """TT speedup of a policy over a baseline (>1 means faster)."""
    return baseline / max(policy, 1e-12)


def geomean(xs: Sequence[float]) -> float:
    return float(np.exp(np.mean(np.log(np.maximum(np.asarray(xs), 1e-12)))))



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
    #: Per-quantum traffic timelines.  The host loop counts these as it
    #: goes; device runs rebuild them from the flat job logs
    #: (:meth:`from_device_logs`), so both engines expose the same
    #: timeline API.
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
    #: Host-loop detector diagnostics: per-quantum count of cores the
    #: ``repro_torch.ft.StragglerDetector`` EWMA state machine currently
    #: flags.  Host loop only (the device engine has no EWMA state).
    straggler_flags: Optional[np.ndarray] = None

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


def bootstrap_ci(values: Sequence[float], n_boot: int = 2000,
                 alpha: float = 0.05, seed: int = 0,
                 stat: Callable = np.mean) -> Tuple[float, float, float]:
    """``(point, lo, hi)`` — percentile-bootstrap confidence interval of
    ``stat`` over ``values`` (seeded, so recorded CIs are reproducible).

    The point estimate is ``stat`` of the sample itself; ``lo``/``hi``
    are the ``alpha/2`` / ``1 - alpha/2`` percentiles of ``n_boot``
    bootstrap replicates.  A sample of one collapses to a degenerate
    ``[point, point]`` interval — single-seed callers stay valid, they
    just carry no width.  ``stat`` must accept an ``axis`` argument
    (``np.mean``/``np.median`` do)."""
    vals = np.asarray(list(values), np.float64)
    if vals.size == 0:
        return float("nan"), float("nan"), float("nan")
    point = float(stat(vals))
    if vals.size == 1:
        return point, point, point
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, vals.size, size=(int(n_boot), vals.size))
    reps = stat(vals[idx], axis=1)
    lo, hi = np.percentile(reps, [100.0 * alpha / 2,
                                  100.0 * (1.0 - alpha / 2)])
    return point, float(lo), float(hi)


@dataclasses.dataclass
class GridStats:
    """Multi-seed aggregation of a scenario grid — the statistics layer
    of the batched simulator (``repro_torch.online.batch_sim``).

    Each *cell* (a scenario label: policy, load point, admission…) holds
    the per-seed :class:`OnlineStats` runs of that scenario;
    :meth:`summary` reduces every flat metric of
    :meth:`OnlineStats.summary` to a mean plus a seeded percentile-
    bootstrap CI, the shape the recorded churn-grid JSONs carry
    (``benchmarks/online_churn.py --seeds K``)."""

    cells: Dict[str, List[OnlineStats]] = dataclasses.field(
        default_factory=dict
    )

    def add(self, cell: str, stats: OnlineStats) -> None:
        self.cells.setdefault(cell, []).append(stats)

    def summary(self, n_boot: int = 2000, alpha: float = 0.05,
                seed: int = 0) -> Dict[str, Dict[str, object]]:
        """``{cell: {metric: mean, ..., "ci": {metric: [lo, hi]},
        "seeds": K}}`` — metric means stay top-level floats so existing
        readers of single-seed summaries keep working unchanged."""
        out: Dict[str, Dict[str, object]] = {}
        for cell, runs in self.cells.items():
            summaries = [r.summary() for r in runs]
            keys = [k for k in summaries[0]
                    if all(k in s for s in summaries)]
            entry: Dict[str, object] = {}
            ci: Dict[str, List[float]] = {}
            for k in keys:
                vals = [float(s[k]) for s in summaries]
                point, lo, hi = bootstrap_ci(
                    vals, n_boot=n_boot, alpha=alpha, seed=seed
                )
                entry[k] = point
                ci[k] = [lo, hi]
            entry["ci"] = ci
            entry["seeds"] = len(runs)
            out[cell] = entry
        return out

    def pooled_slowdowns(self, cell: str) -> np.ndarray:
        """All completed-job slowdowns of a cell, pooled across seeds —
        the sample the cross-seed CCDF is computed on."""
        runs = self.cells.get(cell, [])
        return np.concatenate(
            [np.asarray([j.slowdown(r.quantum_s) for j in r.completed],
                        np.float64)
             for r in runs]
        ) if runs else np.zeros(0)
