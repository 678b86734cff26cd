"""Open-system cluster simulation: arrivals, queueing, departures.

``ClusterSim`` runs the SMT machine as an open queueing system: jobs arrive
(:mod:`repro_torch.online.arrivals`), wait in a FIFO queue while all 2N
hardware contexts are busy, get a free context, run to their §6.2
retired-instruction target under the policy's pairings, and depart.  Odd
active populations leave one application alone on its core (the
idle-context convention).

Two engines: ``engine="host"`` (the default) is the reference's Python
event loop over the numpy machine (:meth:`SMTMachine.open_quantum`), the
policy an :class:`repro_torch.online.allocator.OnlinePolicy` — the
streaming allocator runs its fused step on the device once a quantum;
``engine="scan"`` runs the whole horizon on the device
(:mod:`repro_torch.online.device_sim`).

Determinism: the machine noise/phase stream, the arrival stream and the
policy stream of the host loop are three generators derived from ``seed``
(``seed``, ``seed + 4242``, ``seed + 7919``), drawn in the reference's
order, so a host run is the reference's host run; a device run is a pure
function of (pool, arrivals, policy, faults, seed, draws).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.ft import HeartbeatMonitor, StragglerDetector
from repro_torch.obs import trace as obs_trace
from repro_torch.online.arrivals import ArrivalProcess
from repro_torch.online.faults import FaultProfile
from repro_torch.smt.apps import AppProfile
from repro_torch.smt.machine import PhaseTables, SMTMachine, _VectorState
from repro_torch.smt.metrics import JobRecord, OnlineStats

Pair = Tuple[int, int]


class ClusterSim:
    """One open-system run configuration.

    pool:      application profiles jobs are instances of;
    n_cores:   2-way SMT cores: capacity is ``2 * n_cores`` contexts;
    policy:    under ``engine="host"`` an
               :class:`repro_torch.online.allocator.OnlinePolicy`; under
               ``engine="scan"`` a
               :class:`repro_torch.smt.scan_engine.ScanPolicy` of kind
               ``"synpa"`` or ``"adjacent"``;
    arrivals:  an :class:`repro_torch.online.arrivals.ArrivalProcess`;
    target_scale: scales the §6.2 solo-reference instruction targets;
    admission: ``"fifo"`` (default) admits FIFO into the lowest free slot;
               ``"synergy"`` keeps the FIFO dequeue order but places each
               job by predicted pair score and seeds its ST estimate
               (:class:`repro_torch.online.admission.SynergyAdmission`,
               passed as ``synergy=``);
    engine:    ``"host"`` (default), the event loop below; ``"scan"``, the
               device engine;
    faults:    optional :class:`repro_torch.online.faults.FaultProfile`
               (FIFO admission only, as in the reference).  The host loop
               *detects* faults through the ``repro_torch.ft`` heartbeat
               and straggler state machines; the device engine consumes
               the same schedule as masks;
    device:    where the run's tensors live: ``cuda`` unless the caller
               passes ``device="cpu"``.  A synpa policy's model (a scan
               policy) or the policy itself (a host policy with a
               ``device``) must be there.
    """

    def __init__(
        self,
        machine: SMTMachine,
        pool: Sequence[AppProfile],
        n_cores: int,
        policy,
        arrivals: ArrivalProcess,
        seed: int = 0,
        target_scale: float = 1.0,
        tables: PhaseTables = None,
        admission: str = "fifo",
        synergy=None,
        engine: str = "host",
        faults: Optional[FaultProfile] = None,
        device=None,
    ):
        if engine not in ("host", "scan"):
            raise ValueError(f"unknown engine {engine!r}")
        if n_cores < 1:
            raise ValueError(f"n_cores={n_cores}")
        if admission not in ("fifo", "synergy"):
            raise ValueError(f"unknown admission {admission!r}")
        if admission == "synergy" and synergy is None:
            raise ValueError("admission='synergy' needs a SynergyAdmission")
        if faults is not None and admission != "fifo":
            raise ValueError("fault injection requires admission='fifo'")
        self.device = resolve_device(device)
        if engine == "scan":
            from repro_torch.online.device_sim import DEVICE_SIM_KINDS
            from repro_torch.smt.scan_engine import ScanPolicy

            if not (isinstance(policy, ScanPolicy)
                    and policy.kind in DEVICE_SIM_KINDS):
                raise ValueError(f"engine='scan' needs a ScanPolicy of kind "
                                 f"{DEVICE_SIM_KINDS}, got {policy!r}")
        else:
            if not callable(getattr(policy, "pair", None)):
                raise ValueError(f"engine='host' needs an OnlinePolicy, got "
                                 f"{policy!r}")
            pdev = getattr(policy, "device", None)
            if pdev is not None and pdev.type != self.device.type:
                raise ValueError(f"the policy runs on {pdev}, the "
                                 f"simulation on {self.device}")
        self.faults = faults
        self.machine = machine
        self.pool = list(pool)
        self.n_cores = n_cores
        self.capacity = 2 * n_cores
        self.policy = policy
        self.arrivals = arrivals
        self.seed = seed
        self.target_scale = target_scale
        self.admission = admission
        self.synergy = synergy
        self.engine = engine
        self.tables = tables if tables is not None else PhaseTables.build(
            self.pool)
        assert self.tables.n_apps == len(self.pool)
        # Per-pool-application §6.2 targets and solo times, precomputed so
        # the host loop's arrival/admission bookkeeping is array work per
        # batch of jobs.
        self._pool_target = np.array(
            [machine.target_instructions(p) for p in self.pool]
        ) * target_scale
        self._pool_solo_s = self._pool_target / np.array(
            [machine.solo_retire_rate(p) for p in self.pool]
        ) * machine.params.quantum_s
        self._pool_dur0 = np.array(
            [float(p.phase(0).duration) for p in self.pool]
        )

    def run(self, n_quanta: int, repeats: int = 1, warmup: bool = True,
            draws=None, telemetry: bool = False,
            app_telemetry: bool = False) -> OnlineStats:
        """Run ``n_quanta`` quanta.

        ``engine="scan"``: see
        :func:`repro_torch.online.device_sim.run_device_sim` (a grid of
        such runs goes faster as one run:
        :func:`repro_torch.online.batch_sim.run_device_sim_batched`).

        ``engine="host"``: one pass of the event loop (the run is impure:
        it resets and drives the policy); ``repeats``, ``warmup``,
        ``draws`` and the rings belong to the device engine and are
        refused here, as in the reference.
        """
        if self.engine == "scan":
            from repro_torch.online.device_sim import run_device_sim

            return run_device_sim(self, n_quanta, repeats=repeats,
                                  warmup=warmup, draws=draws,
                                  telemetry=telemetry,
                                  app_telemetry=app_telemetry)
        if (repeats != 1 or draws is not None or telemetry
                or app_telemetry):
            raise ValueError(
                "repeats/draws/telemetry are device-engine knobs; the host "
                "event loop is one pass per call, draws from numpy "
                "generators and records its timelines directly")
        machine, tables = self.machine, self.tables
        quantum_s = machine.params.quantum_s
        rng = np.random.default_rng(self.seed)              # machine stream
        rng_arr = np.random.default_rng(self.seed + 4242)   # arrival stream
        self.policy.reset(machine, np.random.default_rng(self.seed + 7919))

        c = self.capacity
        app_id = np.full(c, -1, np.int64)
        job_at = np.full(c, -1, np.int64)
        st = _VectorState.empty(c)
        queue: Deque[JobRecord] = deque()
        pool_of: List[int] = []         # job_id -> pool index
        records: List[JobRecord] = []   # job_id -> record
        completed: List[JobRecord] = []
        counters = np.zeros((c, 5))
        ran = np.zeros(c, bool)
        prev_pairs: List[Pair] = []
        prev_solo: Optional[int] = None
        pending_departed: List[int] = []

        queue_depth = np.zeros(n_quanta)
        active_hist = np.zeros(n_quanta)
        policy_s = np.zeros(n_quanta)
        solo_quanta = np.zeros(n_quanta)
        # Per-quantum traffic timelines — the host side of the unified
        # timeline API (:meth:`OnlineStats.timelines`); the device engine
        # reconstructs the same three series from its flat job logs.
        arrivals_t = np.zeros(n_quanta)
        admissions_t = np.zeros(n_quanta)
        departures_t = np.zeros(n_quanta)

        # Fault machinery: the pre-sampled schedule is ground truth shared
        # with the device engine; *detection* runs through the ``repro_torch.ft``
        # state machines on a quantum-index clock (a live core beats once
        # per quantum, so one quantum of silence exceeds timeout_s=0.5 and
        # the monitor's newly-dead verdict drives eviction).
        sched = None
        if self.faults is not None:
            fp = self.faults
            sched = fp.schedule(n_quanta, self.n_cores, self.seed)
            ctx_up = sched.ctx_up()
            ctx_speed = sched.ctx_speed()
            core_names = [f"core{k}" for k in range(self.n_cores)]
            core_idx = {nm: k for k, nm in enumerate(core_names)}
            hb = HeartbeatMonitor(list(core_names), timeout_s=0.5)
            for nm in core_names:
                hb.admit(nm, now=-1.0)      # rebase onto the quantum clock
            sdet = StragglerDetector(list(core_names), patience=3)
            retry_pool: Dict[int, int] = {}    # job_id -> eligible quantum
            saved_prog: Dict[int, float] = {}  # job_id -> progress to restore
            n_dropped = 0
            failures_t = np.zeros(n_quanta)
            recoveries_t = np.zeros(n_quanta)
            evictions_t = np.zeros(n_quanta)
            requeues_t = np.zeros(n_quanta)
            straggler_flags_t = np.zeros(n_quanta)

        for q in range(n_quanta):
            # 1. Arrivals enter the queue (per-pool targets precomputed in
            # __init__ — the record build is O(1) per job).
            for pid in self.arrivals.draw(q, rng_arr):
                arrivals_t[q] += 1
                job_id = len(records)
                pid = int(pid)
                rec = JobRecord(
                    job_id=job_id, app_name=self.pool[pid].name, arrive_q=q,
                    admit_q=-1, finish_q=np.inf,
                    target=float(self._pool_target[pid]),
                    solo_s=float(self._pool_solo_s[pid]),
                )
                records.append(rec)
                pool_of.append(pid)
                queue.append(rec)

            # 1b. Fault transitions.  The schedule drives heartbeats; the
            # monitor's newly-dead verdict drives evictions — detection
            # semantics live in ``repro_torch.ft``, this loop only relays beats
            # (and the invariant below proves verdict == schedule).
            arrived_slots: List[int] = []
            hints: Dict[int, np.ndarray] = {}
            avail = app_id < 0
            if sched is not None:
                upq = ctx_up[q]
                for k, nm in enumerate(core_names):
                    if sched.up[q, k]:
                        if nm in hb.dead:
                            hb.admit(nm, now=float(q))   # recovery rejoin
                            recoveries_t[q] += 1
                        else:
                            hb.beat(nm, now=float(q))
                newly_dead = hb.check(now=float(q))
                failures_t[q] = len(newly_dead)
                for nm in sorted(newly_dead, key=core_idx.get):
                    kc = core_idx[nm]
                    for s in (2 * kc, 2 * kc + 1):
                        if app_id[s] < 0:
                            continue
                        jid = int(job_at[s])
                        rec = records[jid]
                        rec.retries += 1
                        evictions_t[q] += 1
                        if rec.retries > fp.max_retries:
                            n_dropped += 1   # work lost — counted, not hidden
                        else:
                            retry_pool[jid] = q + fp.backoff_quanta
                            saved_prog[jid] = (
                                float(st.progress[s])
                                if fp.preserve_progress else 0.0
                            )
                        app_id[s] = -1
                        job_at[s] = -1
                        # Fault churn is departure churn to the allocator.
                        pending_departed.append(s)
                if pending_departed:
                    gone = set(pending_departed)
                    prev_pairs = [p for p in prev_pairs
                                  if not (p[0] in gone and p[1] in gone)]
                    if prev_solo in gone:
                        prev_solo = None
                assert (app_id[~upq] < 0).all(), (
                    "heartbeat detection must evict every job on a down core"
                )
                flagged = sdet.observe({
                    nm: 1.0 / float(sched.speed[q, k])
                    for k, nm in enumerate(core_names) if sched.up[q, k]
                })
                straggler_flags_t[q] = len(flagged)
                avail = (app_id < 0) & upq

                # 2a. Retry re-admission before the fresh queue: eligible
                # victims enter ascending job id into the lowest free up
                # contexts (the device engine's rank matching implements
                # the same order).
                elig = sorted(j for j, at in retry_pool.items() if at <= q)
                (free,) = np.nonzero(avail)
                k = min(len(elig), int(free.size))
                if k:
                    slots = free[:k]
                    jids = np.array(elig[:k], np.int64)
                    pids = np.array([pool_of[j] for j in jids], np.int64)
                    app_id[slots] = pids
                    job_at[slots] = jids
                    st.phase_idx[slots] = 0          # phase state was lost
                    st.phase_left[slots] = self._pool_dur0[pids]
                    st.progress[slots] = [saved_prog[int(j)] for j in jids]
                    st.target[slots] = self._pool_target[pids]
                    st.first_finish_q[slots] = np.inf
                    # total_retired/total_cycles keep accumulating across
                    # retries: they meter machine work spent, not progress.
                    for j in jids:
                        del retry_pool[int(j)]
                        saved_prog.pop(int(j), None)
                    arrived_slots.extend(int(s) for s in slots)
                    requeues_t[q] = k
                    avail[slots] = False

            # 2. Admission: FIFO dequeue into free contexts.  "fifo" takes
            # the k lowest free slots in one batch; "synergy" places each
            # job on the free context with the best predicted co-runner
            # (sequential by construction — each placement sees the
            # previous one's resident — but the per-job placement itself
            # is one vectorised argmin) and records an ST hint for the
            # policy.  Slot-state initialisation is one fancy-indexed
            # write per field, so the bookkeeping stays array work per
            # admission batch — the host tier remains a usable parity
            # oracle past N=4096 under high churn.
            if queue:
                (free,) = np.nonzero(avail)
                k = min(len(queue), int(free.size))
                recs = [queue.popleft() for _ in range(k)]
                pids = np.array(
                    [pool_of[r.job_id] for r in recs], np.int64
                ).reshape(-1)
                if self.admission == "synergy":
                    free_mask = np.zeros(self.capacity, bool)
                    free_mask[free] = True
                    slots = np.empty(k, np.int64)
                    for i in range(k):
                        pid = int(pids[i])
                        (fs,) = np.nonzero(free_mask)
                        s = self.synergy.place(pid, fs, app_id)
                        free_mask[s] = False
                        app_id[s] = pid
                        slots[i] = s
                        hints[s] = self.synergy.hint(pid)
                else:
                    slots = free[:k]
                    app_id[slots] = pids
                if k:
                    job_at[slots] = [r.job_id for r in recs]
                    st.phase_idx[slots] = 0
                    st.phase_left[slots] = self._pool_dur0[pids]
                    st.progress[slots] = 0.0
                    st.target[slots] = self._pool_target[pids]
                    st.first_finish_q[slots] = np.inf
                    st.total_retired[slots] = 0.0
                    st.total_cycles[slots] = 0.0
                    for rec in recs:
                        rec.admit_q = q
                    arrived_slots.extend(int(s) for s in slots)
                admissions_t[q] = k

            (active,) = np.nonzero(app_id >= 0)
            queue_depth[q] = len(queue)
            active_hist[q] = active.size
            if active.size == 0:
                prev_pairs, prev_solo = [], None
                ran[:] = False
                pending_departed = []
                continue

            # 3. The policy pairs the active population.
            t0 = time.perf_counter()
            # ``hints`` rides along only when the admission tier produced
            # any, so hint-oblivious policies (and subclasses predating the
            # keyword) keep their signature under FIFO admission.
            kw = {"hints": hints} if hints else {}
            with obs_trace.span("sim.policy", q=q, n_active=int(active.size)):
                pairs, solo = self.policy.pair(
                    q, active, counters, ran, arrived_slots,
                    pending_departed, prev_pairs, prev_solo, **kw,
                )
            policy_s[q] = time.perf_counter() - t0
            pending_departed = []
            scheduled = sorted(
                [v for p in pairs for v in p]
                + ([solo] if solo is not None else [])
            )
            assert scheduled == [int(s) for s in active], (
                f"policy must cover the active set exactly: "
                f"{scheduled} vs {list(active)}"
            )
            solo_quanta[q] = 0 if solo is None else 1

            # 4. One membership-masked machine quantum.
            with obs_trace.span("sim.quantum", q=q):
                counters, finished = machine.open_quantum(
                    tables, app_id, st,
                    np.asarray(pairs, np.int64).reshape(-1, 2),
                    np.asarray([] if solo is None else [solo], np.int64),
                    rng, q,
                    speed=None if sched is None else ctx_speed[q],
                )
            ran[:] = False
            ran[np.asarray(scheduled, np.int64)] = True

            # 5. Departures free their contexts at quantum end.  Record
            # updates stay per departed job; the slot frees are batched.
            (departed,) = np.nonzero(finished)
            departures_t[q] = departed.size
            for s in departed:
                rec = records[job_at[s]]
                rec.finish_q = float(st.first_finish_q[s])
                completed.append(rec)
            if departed.size:
                app_id[departed] = -1
                job_at[departed] = -1
                pending_departed.extend(int(s) for s in departed)
            prev_pairs = [tuple(int(v) for v in p) for p in pairs]
            prev_solo = None if solo is None else int(solo)
            # Pairs whose members *both* departed carry no information for
            # the next quantum; pairs with one survivor are kept so the
            # allocator can still find the survivor's measurement partner.
            if pending_departed:
                gone = set(pending_departed)
                prev_pairs = [
                    p for p in prev_pairs
                    if not (p[0] in gone and p[1] in gone)
                ]
                if prev_solo in gone:
                    prev_solo = None

        stats = OnlineStats(
            policy_name=getattr(self.policy, "name", "policy"),
            quantum_s=quantum_s,
            quanta=n_quanta,
            completed=completed,
            n_arrived=len(records),
            n_admitted=sum(1 for r in records if r.admit_q >= 0),
            queue_depth=queue_depth,
            active=active_hist,
            policy_s=policy_s,
            solo_quanta=solo_quanta,
            arrivals=arrivals_t,
            admissions=admissions_t,
            departures=departures_t,
        )
        if sched is not None:
            n_in_flight = int((app_id >= 0).sum())
            n_waiting = len(retry_pool)
            # Job conservation: every arrival is exactly one of queued,
            # in flight, completed, dropped, or waiting out a backoff.
            assert len(records) == (len(queue) + n_in_flight + len(completed)
                                    + n_dropped + n_waiting), (
                len(records), len(queue), n_in_flight, len(completed),
                n_dropped, n_waiting,
            )
            stats.failures = failures_t
            stats.recoveries = recoveries_t
            stats.evictions = evictions_t
            stats.requeues = requeues_t
            stats.straggling = sched.straggling()
            stats.straggler_flags = straggler_flags_t
            stats.n_dropped = n_dropped
            stats.n_retry_waiting = n_waiting
            stats.n_in_flight = n_in_flight
        return stats
