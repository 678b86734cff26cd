"""Device-resident open-system engine — ``ClusterSim(engine="scan")``.

The whole open-system cycle

    arrivals -> admission -> scheduling -> machine quantum -> departures

runs on the simulation's device, quantum by quantum, as a Python loop of
device operations (the closed race's form, ``repro_torch.smt.scan_engine``).
All shapes are churn-stable: arrivals and departures change mask contents
and head/tail indices, never shapes.

* **Arrivals are data.**  The arrival process is pre-sampled on the host
  from ``numpy.default_rng(seed + 4242)`` (:func:`repro_torch.online.
  arrivals.presample`) into flat, arrival-sorted ``(arrive_q, pool,
  target)`` job arrays shipped to the device once.
* **The FIFO queue is a pair of indices.**  Jobs are admitted in arrival
  order, so the waiting queue is the window ``[head, tail)`` of the sorted
  job array: ``tail`` is a masked count per quantum, ``head`` advances by
  the admitted count.
* **Admission.**  ``"fifo"`` places the k-th dequeued job on the k-th
  lowest free context.  ``"synergy"`` runs the
  :class:`repro_torch.online.admission.SynergyAdmission` rule: each
  dequeued job in turn goes to the free context whose core-resident
  co-runner has the best Eq. 4 pool cost (empty cores score the expected
  pool cost; ties to the lowest slot), and its solo stack seeds its ST
  estimate.  Its trip count, the number of jobs admitted this quantum, is
  read on the host once a quantum: the engine's one sync of its own,
  counted in :data:`ADMIT_SYNCS`.
* **Scheduling reuses the fused SYNPA step**
  (:func:`repro_torch.core.synpa.make_fused_step`) with membership-masked
  rows.  The idle-context flag (the active population's parity) stays on
  the device: the ``pair_score`` kernel reads it.  The churn-repair
  matcher (:func:`repro_torch.core.matching.device_repair_partner`) keeps
  surviving pairs and repairs the rest; its 2-opt reads its convergence
  flag as the closed race's does (``matching.TWO_OPT_SYNCS``), and the
  solve its fallback flag (``regression.NEED_FB_SYNCS``).
* **The machine quantum is the closed race's**, through the slot ->
  application indirection (``aid``): only active contexts advance;
  departures (``progress >= target``) log a fractional finish quantum and
  free their context at quantum end.
* **Faults are data.**  A :class:`repro_torch.online.faults.FaultProfile`
  is materialised on the host into per-context ``(up, speed)`` arrays:
  jobs on down cores are evicted before admission, re-admitted from a
  bounded retry pool ahead of the fresh queue, and stragglers retire
  ``speed``-scaled instructions.
* **Job bookkeeping is a log.**  ``admit_q``/``finish_q`` (and, with
  faults, ``retries``/``retry_at``/``saved``) are flat per-job tensors.
  Scatters whose masked-off rows must go nowhere write to a sink element
  one past the last job, which is dropped when the logs are fetched once
  at the end of the run.

Random draws are data, as in the closed race: ``draws.noise(q, c)`` and
``draws.phase(q, lam)`` with the closed race's keys, so
:class:`repro_torch.smt.scan_engine.TorchDraws` is the default and a test
can feed the reference's own draws.  With the same draws the run is the
reference's ``run_device_sim``: integer logs identical, finish quanta to
float32.  The first synpa pairing is the repair of the identity carry.

Every tensor of the loop carries a leading lane axis: a single run is a
grid of one lane, and :func:`repro_torch.online.batch_sim.
run_device_sim_batched` runs a grid of scenarios through the same loop,
each quantum's operations launched once for all lanes.

Telemetry.  ``telemetry=True`` records one ``OPEN_FIELDS`` vector a quantum
and ``app_telemetry=True`` one ``APP_FIELDS`` row a context
(:mod:`repro_torch.obs.telemetry`), on the device, fetched once after the
run.  The ring reads the quantum's own slowdown ratios and the policy's
cost matrix before the state moves on, writes nothing back and reads no
flag on the host: a run with rings is the run without them, bit for bit.
As in the reference, the ``departures`` and fault columns are zero on the
device and filled on the host from the fetched logs and the fault
schedule.

Checkpoints.  :func:`run_device_sim_checkpointed` runs the same loop in
segments of quanta, snapshotting the whole state (and the per-quantum
outputs so far) at each segment's end through
:mod:`repro_torch.checkpoint`; a run killed between segments resumes from
its newest valid snapshot and ends bit for bit as the run left alone, and
as :func:`run_device_sim`.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import isc, matching
from repro_torch.core.synpa import fused_pad, make_fused_step
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.telemetry import (
    APP_FIELDS,
    APP_ST_WIDTH,
    FAULT_FIELDS,
    OPEN_FIELDS,
    AppTelemetryLog,
    TelemetryLog,
)
from repro_torch.online.arrivals import presample
from repro_torch.online.faults import RETRY_NEVER
from repro_torch.smt.metrics import OnlineStats
from repro_torch.smt.scan_engine import (
    DeviceTables,
    LaneDraws,
    ScanPolicy,
    TorchDraws,
    _corun_components_scan,
    _machine_partner_of,
    _pmu_counters_scan,
)

#: Kinds of :class:`repro_torch.smt.scan_engine.ScanPolicy` the open system
#: runs: the fused SYNPA tier and the deterministic slot-ordered baseline.
DEVICE_SIM_KINDS = ("synpa", "adjacent")

#: Host reads of synergy admission's trip count (once a quantum under
#: ``admission="synergy"``): the open loop's own device-to-host sync.
ADMIT_SYNCS = 0

#: Host round trips of :func:`run_device_sim_checkpointed`: one a segment,
#: the snapshot's single device-to-host copy.
CKPT_SYNCS = 0

#: The per-quantum series of a run, in output order, as snapshots name
#: them; a faulted run adds ``_FAULT_YS``, rings ``telemetry`` and
#: ``app_telemetry``.
_YS = ("queue_depth", "n_active", "n_solo")
_FAULT_YS = ("evictions", "requeues")


class _OpenCarry(NamedTuple):
    """The open system's state between quanta, one row a lane: context
    membership, queue head and per-job logs.  Shapes depend only on
    (lanes, capacity, padded job count).  Per-job logs that take masked
    scatters carry a sink element at index ``j_pad``."""

    app_id: torch.Tensor        # (L, C) int64  pool row per context (-1 = empty)
    job_at: torch.Tensor        # (L, C) int64  job id per context (-1)
    phase_idx: torch.Tensor     # (L, C) int64
    phase_left: torch.Tensor    # (L, C) f32
    progress: torch.Tensor      # (L, C) f32  retired instructions, current job
    target: torch.Tensor        # (L, C) f32  departure target (inf when empty)
    head: torch.Tensor          # (L, 1) int64 jobs admitted so far
    counters: torch.Tensor      # (L, C, 5) f32 previous quantum's PMU rows
    ran: torch.Tensor           # (L, C) bool context executed last quantum
    partner_prev: torch.Tensor  # (L, C) int64 machine partner last quantum
    mpart: torch.Tensor         # (L, P) int64 matcher partner carry
    st: torch.Tensor            # (L, C, 4) f32 ST estimates
    admit_q: torch.Tensor       # (L, J) int64 admission quantum per job (-1)
    finish_q: torch.Tensor      # (L, J + 1) f32 fractional finish quantum


class _FaultCarry(NamedTuple):
    """Per-job retry bookkeeping of a faulted run, each with a sink."""

    retries: torch.Tensor       # (L, J + 1) int64 evictions suffered so far
    retry_at: torch.Tensor      # (L, J + 1) int64 quantum eligible again
    saved: torch.Tensor         # (L, J + 1) f32  progress to restore


class _LaneCfg(NamedTuple):
    """Per-lane scenario knobs, carried as data: the admission rule and
    the retry policy, which lanes of one grid may choose apart.  Each is
    an (L, 1) tensor; a lane that is not faulted carries knobs that never
    fire."""

    is_syn: torch.Tensor        # bool   synergy admission
    max_retries: torch.Tensor   # int64  retry cap
    backoff: torch.Tensor       # int64  requeue backoff (quanta)
    preserve: torch.Tensor      # bool   keep progress on eviction


class _Inputs(NamedTuple):
    """What a run ships to the device once, before its first quantum:
    the shared tables and each lane's jobs, faults and knobs."""

    dt: DeviceTables
    job_pool: torch.Tensor      # (L, J) int64
    job_arrive: torch.Tensor    # (L, J) int64 (padding arrives never)
    job_target: torch.Tensor    # (L, J) f32
    syn_cost: torch.Tensor      # (A, A) f32, shared
    syn_mean: torch.Tensor      # (A,) f32
    syn_stacks: torch.Tensor    # (A, 4) f32
    cfg: _LaneCfg
    fup: Optional[torch.Tensor]     # (Q, L, C) bool
    fspeed: Optional[torch.Tensor]  # (Q, L, C) f32


def _make_open_ops(spec: ScanPolicy, params, capacity: int, j_pad: int,
                   admission: str, faults: bool, device,
                   telemetry: bool = False, app_telemetry: bool = False):
    """The per-quantum ``body(inp, state, draws, q) -> (state, outs)``, the
    initial state ``carry0(lanes)`` and ``unpack(state, cols)``, which
    takes the stacked per-quantum outputs (:func:`_stack_outs`) and slices
    the logs to their jobs.

    Every tensor has a leading lane axis; a single run is one lane.
    ``admission`` is ``"fifo"``, ``"synergy"`` or ``"lane"``: the last
    computes both rules every quantum and selects one per lane by
    ``cfg.is_syn``, with synergy's trip count the maximum over the
    synergy lanes alone (the un-selected rule's values are dead).
    With ``faults`` (any lane faulted) the fault path runs, its knobs
    read from ``cfg``, and unfaulted lanes ride an
    all-up schedule at unit speed (multiplying by exactly 1.0 changes no
    value).

    ``telemetry`` appends each quantum's ``OPEN_FIELDS`` vector, (L, 21),
    to the outputs, and ``app_telemetry`` (which implies it) its
    ``APP_FIELDS`` block, (L, C, 9)."""
    telemetry = telemetry or app_telemetry
    if admission not in ("fifo", "synergy", "lane"):
        raise ValueError(f"unknown admission {admission!r}")
    lane_mode = admission == "lane"
    c = capacity
    p = fused_pad(c)
    idx = torch.arange(c, device=device)
    core_mate = idx ^ 1
    jobs_idx = torch.arange(j_pad, device=device)
    cycles = float(np.float32(params.quantum_cycles))
    use_hints = spec.kind == "synpa" and admission != "fifo"
    if spec.kind == "synpa":
        if spec.method is None or spec.model is None:
            raise ValueError("synpa open system needs a stack method and a "
                             "fitted model")
        if spec.matcher not in ("refine", "full"):
            raise ValueError(f"unknown matcher {spec.matcher!r}")
        fstep = make_fused_step(spec.method, spec.model,
                                with_diag=telemetry)
        ncat = spec.method.n_categories
    else:
        fstep = None
        ncat = 4
    uniform = torch.as_tensor(isc.uniform_stack(ncat), device=device)
    full_budget = 4 * (p // 2)
    pad_false = torch.zeros(1, p - c - 1, dtype=torch.bool, device=device)

    def clip_job(j):
        return torch.clamp(j, 0, j_pad - 1)

    # ----------------------------------------------------------- admission
    def admit_fifo(app_id, job_at, free, head, tail, job_pool):
        """k-th dequeued job -> k-th lowest free context."""
        n_admit = torch.minimum(tail - head, free.sum(-1, keepdim=True))
        frank = torch.cumsum(free.to(torch.int64), -1) - 1
        take = free & (frank < n_admit)
        jidx = torch.where(take, head + frank, j_pad)
        pid = job_pool.gather(-1, clip_job(jidx))
        return (torch.where(take, pid, app_id), torch.where(take, jidx, job_at),
                take, head + n_admit)

    def admit_synergy(app_id, job_at, head, tail, inp):
        """FIFO dequeue order, predicted-best placement: each dequeued job
        sees the residents the previous one placed.  A lane runs its own
        count of trips; the loop runs the most any synergy lane needs,
        read on the host once a quantum (counted in ``ADMIT_SYNCS``)."""
        global ADMIT_SYNCS
        n_admit = torch.minimum(tail - head, (app_id < 0).sum(-1, keepdim=True))
        n_trip = (torch.where(inp.cfg.is_syn, n_admit, 0) if lane_mode
                  else n_admit)
        ADMIT_SYNCS += 1
        trips = int(n_trip.max() if n_trip.numel() > 1 else n_trip)
        job_at0 = job_at
        for k in range(trips):
            j = head + k
            pid = inp.job_pool.gather(-1, clip_job(j))
            mate = app_id[..., core_mate]
            mcost = torch.where(mate >= 0,
                                inp.syn_cost[pid, torch.clamp(mate, min=0)],
                                inp.syn_mean[pid])
            cost_s = torch.where(app_id < 0, mcost, torch.inf)
            put = idx == torch.argmin(cost_s, -1, keepdim=True)  # ties: lowest
            if n_trip.numel() > 1:   # a lane past its own trips places none
                put = put & (k < n_trip)
            app_id = torch.where(put, pid, app_id)
            job_at = torch.where(put, j, job_at)
        return app_id, job_at, job_at != job_at0, head + n_admit

    # ------------------------------------------------------------ policies
    def adjacent_partner(active, n_active):
        """Slot-ordered pairing of the active set; odd leaves the highest
        active rank solo."""
        arank = torch.cumsum(active.to(torch.int64), -1) - 1
        slot_of_rank = torch.zeros(active.shape[:-1] + (c + 1,),
                                   dtype=torch.int64, device=device).scatter(
            -1, torch.where(active, arank, c), idx.expand(active.shape))
        mate = arank ^ 1
        return torch.where(
            active & (mate < n_active),
            slot_of_rank.gather(-1, torch.clamp(mate, 0, c - 1)), idx)

    # ------------------------------------------------ open machine quantum
    def open_quantum(dt, aid, active, phase_idx, phase_left, progress,
                     target, partner, draws, q, speed=None):
        """Membership-masked quantum: departures, no relaunch.  ``speed``
        (straggler capability) scales retirement only.  With rings on it
        also returns each context's slowdown ratio (0 where empty)."""
        aid_safe = torch.clamp(aid, min=0)
        nph = dt.n_phases[aid_safe]
        ph = phase_idx % nph
        partner_m = torch.where(active & active.gather(-1, partner), partner,
                                idx)
        comps = _corun_components_scan(dt, ph, partner_m, params,
                                       aid=aid_safe)
        cpi = comps.sum(-1)
        retired = torch.where(active, cycles / cpi * dt.retire[aid_safe], 0.0)
        if speed is not None:
            retired = retired * speed
        after = progress + retired
        done = active & (after >= target)
        frac = torch.clamp((target - progress)
                           / torch.clamp(retired, min=1e-9), 0.0, 1.0)
        counters = _pmu_counters_scan(comps, dt.omega[aid_safe],
                                      dt.retire[aid_safe], cycles, params,
                                      draws.noise(q, c))
        counters = torch.where(active[..., None], counters, 0.0)
        # Phase advance for survivors only (departed jobs leave at quantum
        # end); draws are per (context, quantum), occupancy-blind.
        surv = active & ~done
        left = phase_left - 1.0
        trans = surv & (left <= 0.0)
        nidx = phase_idx + trans.to(torch.int64)
        lam = dt.duration[aid_safe, nidx % nph]
        drawn = draws.phase(q, lam).to(torch.float32)
        new_left = torch.where(trans, torch.clamp(drawn, min=1.0),
                               torch.where(surv, left, phase_left))
        new_idx = torch.where(trans, nidx, phase_idx)
        out = (counters, after, done, frac, new_idx, new_left)
        if telemetry:
            solo_cpi = dt.comps[aid_safe, ph].sum(-1)
            out += (torch.where(active, cpi / solo_cpi, 0.0),)
        return out

    # --------------------------------------------------------------- body
    def body(inp: _Inputs, state, draws, q: int):
        carry, fc = state
        dt = inp.dt
        cfg = inp.cfg
        # 1. Arrivals: the queue tail is a masked count over the sorted
        # job array.
        tail = (inp.job_arrive <= q).sum(-1, keepdim=True)
        app_id, job_at = carry.app_id, carry.job_at
        if faults:
            # 1b. Fault eviction: jobs on cores that are down this quantum
            # leave before admission.
            upq = inp.fup[q]
            speedq = inp.fspeed[q]
            evict = (app_id >= 0) & ~upq
            ej = torch.where(evict, job_at, j_pad)
            retries = fc.retries.scatter_add(-1, ej, evict.to(torch.int64))
            over = retries.gather(-1, ej) > cfg.max_retries
            requeue_c = evict & ~over          # dropped past max_retries
            retry_at = fc.retry_at.scatter(
                -1, torch.where(requeue_c, ej, j_pad),
                (q + cfg.backoff).expand(ej.shape))
            saved_val = torch.where(cfg.preserve, carry.progress, 0.0)
            saved = fc.saved.scatter(-1, ej, saved_val)
            n_evict = evict.sum(-1)
            app_id = torch.where(evict, -1, app_id)
            job_at = torch.where(evict, -1, job_at)

            # 2a. Retry pool ahead of the fresh queue: the r-th eligible
            # victim (ascending job id) re-enters on the r-th lowest free
            # up context.
            free = (app_id < 0) & upq
            elig = retry_at[..., :j_pad] <= q
            n_take = torch.minimum(elig.sum(-1, keepdim=True),
                                   free.sum(-1, keepdim=True))
            erank = torch.cumsum(elig.to(torch.int64), -1) - 1
            take_j = elig & (erank < n_take)
            job_of_rank = torch.full(app_id.shape[:-1] + (c + 1,), j_pad,
                                     dtype=torch.int64, device=device).scatter(
                -1, torch.where(take_j, erank, c), jobs_idx.expand(elig.shape))
            frank = torch.cumsum(free.to(torch.int64), -1) - 1
            rtake = free & (frank < n_take)
            jr = torch.where(
                rtake, job_of_rank.gather(-1, torch.clamp(frank, 0, c - 1)),
                j_pad)
            app_id = torch.where(rtake, inp.job_pool.gather(-1, clip_job(jr)),
                                 app_id)
            job_at = torch.where(rtake, jr, job_at)
            retry_at = retry_at.scatter(
                -1, torch.where(rtake, jr, j_pad),
                torch.full(jr.shape, int(RETRY_NEVER), dtype=torch.int64,
                           device=device))
            n_requeue = rtake.sum(-1)
            free = free & ~rtake
        else:
            free = app_id < 0

        # 2. Admission into free contexts (FIFO dequeue order either way).
        if admission != "fifo":
            s_app, s_job, s_took, s_head = admit_synergy(
                app_id, job_at, carry.head, tail, inp)
        if admission != "synergy":
            f_app, f_job, f_took, f_head = admit_fifo(
                app_id, job_at, free, carry.head, tail, inp.job_pool)
        if admission == "synergy":
            app_id, job_at, took_f, head = s_app, s_job, s_took, s_head
        elif admission == "fifo":
            app_id, job_at, took_f, head = f_app, f_job, f_took, f_head
        else:
            app_id = torch.where(cfg.is_syn, s_app, f_app)
            job_at = torch.where(cfg.is_syn, s_job, f_job)
            took_f = torch.where(cfg.is_syn, s_took, f_took)
            head = torch.where(cfg.is_syn, s_head, f_head)
        # ``took``: every newly placed context (fresh and retry); ``took_f``
        # the fresh ones, which alone move the queue head and admit log.
        took = (took_f | rtake) if faults else took_f
        jidx = clip_job(torch.where(took, job_at, j_pad))
        target = torch.where(took, inp.job_target.gather(-1, jidx),
                             carry.target)
        phase_idx = torch.where(took, 0, carry.phase_idx)
        phase_left = torch.where(
            took, dt.duration[torch.clamp(app_id, min=0), 0],
            carry.phase_left)
        if faults:
            # Re-admissions restart at phase 0 with their saved progress.
            progress = torch.where(
                rtake, saved.gather(-1, jidx),
                torch.where(took_f, 0.0, carry.progress))
        else:
            progress = torch.where(took, 0.0, carry.progress)
        # Fresh admissions are the queue window [carry.head, head).
        admit_q = torch.where((jobs_idx >= carry.head) & (jobs_idx < head),
                              q, carry.admit_q)
        st = carry.st
        if use_hints:
            # A newcomer's estimate is its profiled solo stack (synergy
            # lanes only).
            hint = (took & cfg.is_syn) if lane_mode else took
            st = torch.where(hint[..., None],
                             inp.syn_stacks[torch.clamp(app_id, min=0)], st)

        active = app_id >= 0
        n_active = active.sum(-1, keepdim=True)
        odd = (n_active % 2) == 1
        queue_depth = tail - head

        # 3. Policy: pair the active population off the previous quantum's
        # counters.
        if spec.kind == "adjacent":
            partner = adjacent_partner(active, n_active)
            mpart = carry.mpart
            if telemetry:
                # No predictor, no matcher: the policy fields are zero.
                pol = torch.zeros(active.shape[:-1] + (7,), device=device)
                pred_ctx = torch.zeros(active.shape, device=device)
        else:
            solve = carry.ran & (carry.partner_prev != idx)
            solo_m = carry.ran & (carry.partner_prev == idx)
            # Hinted (synergy) lanes skip the fresh reset.
            if lane_mode:
                fresh = took & ~cfg.is_syn
            else:
                fresh = torch.zeros_like(took) if use_hints else took
            masks = torch.stack([solve, solo_m, active, fresh], dim=-2)
            cost, st, *fdiag = fstep(carry.counters, carry.partner_prev, st,
                                     masks, odd.reshape(-1))
            valid_p = torch.cat([active, odd,
                                 pad_false.expand(active.shape[0], -1)], -1)
            if spec.matcher == "full":
                mpart = matching.device_pairs_partner(
                    cost, valid_p, eps=spec.refine_eps,
                    max_rounds=full_budget, with_rounds=telemetry)
                if telemetry:
                    # A full re-match rebuilds every pair: the whole valid
                    # population counts as dirty.
                    mpart, rounds = mpart
                    dirty = valid_p.sum(-1)
            else:
                mpart = matching.device_repair_partner(
                    cost, carry.mpart, valid_p, eps=spec.refine_eps,
                    max_rounds=spec.refine_rounds, with_diag=telemetry)
                if telemetry:
                    mpart, rounds, dirty = mpart
            if telemetry:
                # Mean predicted cost per committed pair (each pair's entry
                # appears twice over n_valid / 2 pairs), and each
                # context's share of its pair: half its entry.
                n_valid = torch.clamp(valid_p.sum(-1).to(torch.float32),
                                      min=1.0)
                gathered = torch.where(
                    valid_p, cost.gather(-1, mpart[..., None])[..., 0], 0.0)
                pol = torch.cat([torch.stack(
                    [gathered.sum(-1) / n_valid, dirty.to(torch.float32),
                     rounds.to(torch.float32)], -1), fdiag[0]], -1)
                pred_ctx = gathered[..., :c] * 0.5
            partner = torch.where(active, _machine_partner_of(mpart, c), idx)

        # 4. One membership-masked machine quantum, 5. departures.
        counters, after, done, frac, phase_idx, phase_left, *ratio = \
            open_quantum(dt, app_id, active, phase_idx, phase_left, progress,
                         target, partner, draws, q,
                         speed=speedq if faults else None)
        finish_q = carry.finish_q.scatter(
            -1, torch.where(done, job_at, j_pad), q + frac)
        n_solo = (active & (partner == idx)).sum(-1)
        new = _OpenCarry(
            app_id=torch.where(done, -1, app_id),
            job_at=torch.where(done, -1, job_at),
            phase_idx=phase_idx,
            phase_left=phase_left,
            progress=after,
            target=torch.where(done, torch.inf, target),
            head=head,
            counters=counters,
            ran=active,
            partner_prev=partner,
            mpart=mpart,
            st=st,
            admit_q=admit_q,
            finish_q=finish_q,
        )
        outs = (queue_depth[..., 0], n_active[..., 0], n_solo)
        if faults:
            outs = outs + (n_evict, n_requeue)
            fc = _FaultCarry(retries=retries, retry_at=retry_at, saved=saved)
        if telemetry:
            ratio = ratio[0]
            f32 = lambda v: v.to(torch.float32)  # noqa: E731
            lanes = active.shape[:-1]
            # Departures and the fault columns are filled on the host.
            outs = outs + (torch.cat([
                torch.stack([
                    f32(head[..., 0]), f32(tail[..., 0]),
                    f32(queue_depth[..., 0]), f32(took_f.sum(-1)),
                    torch.zeros(lanes, device=device),
                    f32(n_active[..., 0]), f32(n_solo),
                    ratio.sum(-1) / torch.clamp(f32(n_active[..., 0]),
                                                min=1.0),
                    ratio.amax(-1)], -1),
                pol,
                torch.zeros(lanes + (len(FAULT_FIELDS),), device=device),
            ], -1),)
        if app_telemetry:
            co = active & active.gather(-1, partner) & (partner != idx)
            partner_app = torch.where(co, app_id.gather(-1, partner), -1)
            pred_col = torch.where(co, pred_ctx, 0.0)
            resid = torch.where(pred_col > 0.0, pred_col - ratio, 0.0)
            st4 = st[..., :APP_ST_WIDTH]
            if st4.shape[-1] < APP_ST_WIDTH:
                st4 = torch.cat([st4, st4.new_zeros(
                    st4.shape[:-1] + (APP_ST_WIDTH - st4.shape[-1],))], -1)
            st4 = torch.where(active[..., None], st4, 0.0)
            outs = outs + (torch.cat([torch.stack([
                f32(app_id), f32(partner_app), pred_col, ratio, resid], -1),
                st4], -1),)
        return (new, fc), outs

    def carry0(lanes: int):
        def full(shape, value, dtype=torch.float32):
            return torch.full((lanes,) + shape, value, dtype=dtype,
                              device=device)

        ocarry = _OpenCarry(
            app_id=full((c,), -1, torch.int64),
            job_at=full((c,), -1, torch.int64),
            phase_idx=full((c,), 0, torch.int64),
            phase_left=full((c,), 0.0),
            progress=full((c,), 0.0),
            target=full((c,), torch.inf),
            head=full((1,), 0, torch.int64),
            counters=full((c, 5), 0.0),
            ran=full((c,), False, torch.bool),
            partner_prev=idx.expand(lanes, c).clone(),
            mpart=torch.arange(p, device=device).expand(lanes, p).clone(),
            st=uniform.expand(lanes, c, uniform.shape[-1]).clone(),
            admit_q=full((j_pad,), -1, torch.int64),
            finish_q=full((j_pad + 1,), torch.inf),
        )
        fc = _FaultCarry(
            retries=full((j_pad + 1,), 0, torch.int64),
            retry_at=full((j_pad + 1,), int(RETRY_NEVER), torch.int64),
            saved=full((j_pad + 1,), 0.0),
        ) if faults else None
        return ocarry, fc

    def unpack(state, cols):
        """The run's logs from its final state and stacked outputs, as
        tensors or, for a state and outputs fetched to the host, numpy."""
        ocarry, fc = state
        res = (ocarry.admit_q, ocarry.finish_q[..., :j_pad]) + tuple(cols[:3])
        if faults:
            res = res + (fc.retries[..., :j_pad], fc.retry_at[..., :j_pad]) \
                + tuple(cols[3:5])
        return res + tuple(cols[len(cols) - telemetry - app_telemetry:])

    return body, carry0, unpack


def _stack_outs(outs):
    """A span of quanta's outputs, one column each with the quanta on
    axis 1: the (L,) series as (L, Q), the rings as (L, Q, ...)."""
    return [torch.stack(col, 1) for col in zip(*outs)]


def _build_race(spec: ScanPolicy, params, capacity: int, n_quanta: int,
                j_pad: int, admission: str, faults=False, device=None,
                telemetry: bool = False, app_telemetry: bool = False,
                segment: bool = False):
    """One open-system run over a grid of lanes: ``race(inputs, draws)``
    -> ``(admit_q (L, J), finish_q (L, J), queue_depth (L, Q), n_active
    (L, Q), n_solo (L, Q))`` on the device, and with ``faults``
    also ``retries (L, J), retry_at (L, J), evictions (L, Q), requeues
    (L, Q)``, then the ``telemetry`` ring (L, Q, 21) and the
    ``app_telemetry`` ring (L, Q, C, 9).  ``draws`` gives each quantum's
    numbers for all lanes (a :class:`repro_torch.smt.scan_engine.
    LaneDraws`).

    ``segment=True`` returns the checkpointed form instead,
    ``race(inputs, draws, state, q0) -> (state, cols)``: quanta ``q0 ..
    q0 + n_quanta - 1`` (``n_quanta`` is then the segment's length) from
    ``state`` (the initial state when None), with the state at the end and
    the segment's stacked outputs; ``race.unpack(state, cols)`` gives the
    logs.  The quantum index keys the draws, the arrivals and the fault
    schedule, so segments of one run are that run."""
    body, carry0, unpack = _make_open_ops(
        spec, params, capacity, j_pad, admission, faults, device,
        telemetry=telemetry, app_telemetry=app_telemetry)

    def run(inputs, draws, state, q0):
        if state is None:
            state = carry0(inputs.job_pool.shape[0])
        outs = []
        for q in range(q0, q0 + n_quanta):
            state, out = body(inputs, state, draws, q)
            outs.append(out)
        return state, _stack_outs(outs)

    if segment:
        run.unpack = unpack
        return run

    def race(inputs, draws):
        return unpack(*run(inputs, draws, None, 0))

    return race


def _prepare_inputs(sim, n_quanta: int):
    """Host-side prologue: pre-sample arrivals (and the fault schedule when
    the sim carries a FaultProfile), build the flat job arrays and the
    synergy tables.  Everything returned is numpy."""
    machine = sim.machine
    pool = sim.pool
    rng_arr = np.random.default_rng(sim.seed + 4242)
    arrive_q, pids = presample(sim.arrivals, n_quanta, rng_arr)
    j = int(pids.size)
    # Jobs pad to the next power of two, as the reference's compiled race
    # keys them.
    j_pad = max(8, 1 << (j - 1).bit_length()) if j else 8
    pool_target = np.array(
        [machine.target_instructions(pr) for pr in pool]
    ) * sim.target_scale
    pool_rate = np.array([machine.solo_retire_rate(pr) for pr in pool])
    job_pool = np.zeros(j_pad, np.int64)
    job_arrive = np.full(j_pad, n_quanta, np.int64)  # padding never arrives
    job_target = np.full(j_pad, np.inf, np.float32)
    if j:
        job_pool[:j] = pids
        job_arrive[:j] = arrive_q
        job_target[:j] = pool_target[pids]
    n_apps = sim.tables.n_apps
    if sim.admission == "synergy":
        syn_cost = np.asarray(sim.synergy.pool_cost, np.float32)
        syn_mean = np.asarray(sim.synergy.mean_cost, np.float32)
        syn_stacks = np.asarray(sim.synergy.stacks, np.float32)
    else:
        syn_cost = np.zeros((n_apps, n_apps), np.float32)
        syn_mean = np.zeros(n_apps, np.float32)
        syn_stacks = np.zeros((n_apps, isc.N_CATS), np.float32)
    faults = sim.faults
    if faults is not None:
        sched = faults.schedule(n_quanta, sim.n_cores, sim.seed)
        fcfg = faults.static_config
        fup = sched.ctx_up()
        fspeed = sched.ctx_speed()
    else:
        sched, fcfg, fup, fspeed = None, None, None, None
    return dict(
        arrive_q=arrive_q, pids=pids, j=j, j_pad=j_pad,
        pool_rate=pool_rate, job_pool=job_pool, job_arrive=job_arrive,
        job_target=job_target, syn_cost=syn_cost, syn_mean=syn_mean,
        syn_stacks=syn_stacks, faults=faults, sched=sched, fcfg=fcfg,
        fup=fup, fspeed=fspeed,
    )


def _repad(arr: np.ndarray, j_pad: int, fill) -> np.ndarray:
    out = np.full(j_pad, fill, arr.dtype)
    out[: arr.size] = arr
    return out


def _commit(sims, preps, j_pad: int, n_quanta: int, syn_tables,
            device) -> _Inputs:
    """Ship a grid's inputs to the device, once: each lane's job arrays
    re-padded to ``j_pad`` (padding jobs arrive never and have an infinite
    target, so a wider pad changes no trajectory), its fault schedule
    (all up at unit speed for an unfaulted lane of a faulted grid) and its
    knobs; ``syn_tables`` ``(cost, mean, stacks)`` are shared."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    c = sims[0].capacity
    faulted = [prep["fcfg"] is not None for prep in preps]
    fup = fspeed = None
    if any(faulted):
        fup = t(np.stack([prep["fup"] if f else np.ones((n_quanta, c), bool)
                          for prep, f in zip(preps, faulted)], 1), torch.bool)
        fspeed = t(np.stack([
            prep["fspeed"] if f else np.ones((n_quanta, c), np.float32)
            for prep, f in zip(preps, faulted)], 1), torch.float32)
    knobs = np.array([prep["fcfg"][:3] if f else (0, 0, True)
                      for prep, f in zip(preps, faulted)], np.int64)
    cfg = _LaneCfg(
        is_syn=t([[sim.admission == "synergy"] for sim in sims], torch.bool),
        max_retries=t(knobs[:, :1], torch.int64),
        backoff=t(knobs[:, 1:2], torch.int64),
        preserve=t(knobs[:, 2:3], torch.bool),
    )
    return _Inputs(
        dt=DeviceTables.build(sims[0].tables, device),
        job_pool=t(np.stack([_repad(prep["job_pool"], j_pad, 0)
                             for prep in preps]), torch.int64),
        job_arrive=t(np.stack([_repad(prep["job_arrive"], j_pad, n_quanta)
                               for prep in preps]), torch.int64),
        job_target=t(np.stack([_repad(prep["job_target"], j_pad, np.inf)
                               for prep in preps]), torch.float32),
        syn_cost=t(syn_tables[0], torch.float32),
        syn_mean=t(syn_tables[1], torch.float32),
        syn_stacks=t(syn_tables[2], torch.float32),
        cfg=cfg,
        fup=fup,
        fspeed=fspeed,
    )


def _check_conservation(prep, n_quanta, admit, finish, retries, retry_at):
    """The job-conservation invariant of a faulted run: every arrived job
    is exactly one of completed / in flight / queued / waiting out a retry
    backoff / dropped."""
    j = prep["j"]
    if not j:
        return
    max_retries = prep["fcfg"][0]
    admit = admit[:j]
    finish = finish[:j]
    retries = retries[:j]
    retry_at = retry_at[:j]
    completed = np.isfinite(finish)
    waiting = retry_at < int(RETRY_NEVER)
    dropped = retries > max_retries
    queued = admit < 0
    in_flight = (~completed) & (~waiting) & (~dropped) & (~queued)
    states = (completed.astype(int) + waiting.astype(int)
              + dropped.astype(int) + queued.astype(int)
              + in_flight.astype(int))
    assert (states == 1).all(), (
        "job-conservation violation: some job is in "
        f"{int((states != 1).sum())} states"
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lane_mode(sims) -> str:
    """The admission mode of a grid: one rule for all lanes, or
    ``"lane"`` when its lanes differ."""
    rules = {sim.admission for sim in sims}
    return rules.pop() if len(rules) == 1 else "lane"


def _grid_race(sims, preps, n_quanta: int, j_pad: int, syn_tables, draws,
               telemetry: bool = False, app_telemetry: bool = False,
               segment: bool = False):
    """A grid of lanes, built and committed: ``run()`` runs the whole
    horizon once and returns the logs on the device (with ``segment``,
    ``run(state, q0)`` runs one segment; see :func:`_build_race`)."""
    base = sims[0]
    faulted = any(prep["fcfg"] is not None for prep in preps)
    race = _build_race(base.policy, base.machine.params, base.capacity,
                       n_quanta, j_pad, _lane_mode(sims),
                       faulted, base.device, telemetry=telemetry,
                       app_telemetry=app_telemetry, segment=segment)
    with obs_trace.span("device_sim.commit", lanes=len(sims)):
        inputs = _commit(sims, preps, j_pad, n_quanta, syn_tables,
                         base.device)
    if segment:
        def run(state, q0):
            return race(inputs, draws, state, q0)
        run.unpack = race.unpack
        return run
    return lambda: race(inputs, draws)


def _run_lanes(sims, preps, n_quanta: int, j_pad: int, syn_tables,
               repeats: int, warmup: bool, draws, telemetry: bool = False,
               app_telemetry: bool = False):
    """Run a grid of lanes: an untimed warm run when ``warmup``, then
    ``repeats`` timed runs, each bracketed by ``torch.cuda.synchronize()``
    on a GPU.  Returns the fetched logs (numpy, lane axis first) and the
    median wall of the timed runs."""
    device = sims[0].device
    run = _grid_race(sims, preps, n_quanta, j_pad, syn_tables, draws,
                     telemetry=telemetry, app_telemetry=app_telemetry)
    out = None
    if warmup:
        out = run()
        obs_trace.dispatch_cost("device_sim.race", run, device)
    walls = []
    for _ in range(max(int(repeats), 1)):
        _sync(device)
        t0 = time.perf_counter()
        with obs_trace.span("device_sim.dispatch", lanes=len(sims),
                            quanta=n_quanta):
            out = run()
            _sync(device)
        walls.append(time.perf_counter() - t0)
    return tuple(o.cpu().numpy() for o in out), float(np.median(walls))


def _fetch_host(tensors):
    """Tensors to numpy arrays through ONE device-to-host copy: their
    bytes packed into one buffer on the device, fetched, and cut apart on
    the host."""
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
            for t in tensors]
    host = torch.cat(flat).cpu().numpy() if flat else np.zeros(0, np.uint8)
    out, at = [], 0
    for t, f in zip(tensors, flat):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(host[at:at + f.numel()].copy().view(dtype)
                   .reshape(tuple(t.shape)))
        at += f.numel()
    return out


def _lane_stats(sim, prep, n_quanta: int, fetched, i: int,
                per_quantum: float, telemetry: bool = False,
                app_telemetry: bool = False) -> OnlineStats:
    """Lane ``i``'s :class:`OnlineStats` from a grid's fetched logs (the
    rings, when the run recorded them, last); a faulted lane's
    job-conservation invariant is checked here, and its ring's fault
    columns filled from the schedule and its counts."""
    telemetry = telemetry or app_telemetry
    params = sim.machine.params
    j = prep["j"]
    arrive_q, pids = prep["arrive_q"], prep["pids"]
    job_target, pool_rate = prep["job_target"], prep["pool_rate"]
    faulted = prep["fcfg"] is not None
    admit, finish, queue_depth, n_active, n_solo = (f[i] for f in fetched[:5])
    retries = retry_at = None
    if faulted:
        retries, retry_at, evictions, requeues = (f[i] for f in fetched[5:9])
        _check_conservation(prep, n_quanta, admit, finish, retries, retry_at)
    solo_s = (job_target[:j] / pool_rate[pids] * params.quantum_s
              if j else np.zeros(0))
    name = sim.policy.name or f"scan-{sim.policy.kind}"
    stats = OnlineStats.from_device_logs(
        policy_name=name,
        quantum_s=params.quantum_s,
        quanta=n_quanta,
        app_names=[sim.pool[int(pid)].name for pid in pids],
        arrive_q=arrive_q,
        admit_q=admit[:j],
        finish_q=finish[:j],
        targets=job_target[:j],
        solo_s=solo_s,
        queue_depth=queue_depth,
        active=n_active,
        policy_s=np.full(n_quanta, per_quantum),
        solo_quanta=n_solo,
        retries=retries[:j] if faulted else None,
    )
    if faulted:
        _attach_fault_stats(stats, prep, retries, retry_at, evictions,
                            requeues)
    rings = fetched[len(fetched) - telemetry - app_telemetry:]
    if telemetry:
        # Filled here, as the reference fills them: departures are
        # ``bincount(floor(finish_q))``, the fault columns schedule data
        # and the run's eviction and requeue counts.
        ring = np.array(rings[0][i], np.float64)
        ring[:, OPEN_FIELDS.index("departures")] = stats.departures
        if faulted:
            for nm in FAULT_FIELDS:
                ring[:, OPEN_FIELDS.index(nm)] = getattr(stats, nm)
        stats.telemetry = TelemetryLog(OPEN_FIELDS, ring, policy=name)
    if app_telemetry:
        stats.app_telemetry = AppTelemetryLog(APP_FIELDS, rings[1][i],
                                              policy=name)
    return stats


def run_device_sim(sim, n_quanta: int, repeats: int = 1, warmup: bool = True,
                   draws=None, telemetry: bool = False,
                   app_telemetry: bool = False) -> OnlineStats:
    """Run a :class:`repro_torch.online.sim.ClusterSim` configuration on its
    device.

    ``warmup`` runs the whole horizon once untimed; then ``repeats`` timed
    runs, each bracketed by ``torch.cuda.synchronize()`` on a GPU, give
    the median wall time per quantum in ``OnlineStats.policy_s`` (policy,
    machine and bookkeeping together, spread over the horizon).  Every run
    is the same (the draws are keyed per quantum).  ``draws`` defaults to
    :class:`repro_torch.smt.scan_engine.TorchDraws` keyed from the sim's
    seed.

    ``telemetry=True`` attaches the ``OPEN_FIELDS`` ring as
    ``OnlineStats.telemetry``, ``app_telemetry=True`` (which implies it)
    also the ``APP_FIELDS`` ring as ``OnlineStats.app_telemetry``; the run
    is the run without them, bit for bit.

    The run is a grid of one lane; to run many scenarios (seeds, loads,
    admission rules, fault profiles) use
    :func:`repro_torch.online.batch_sim.run_device_sim_batched`, which
    runs them all at once, each lane equal to its run here.
    """
    prep = _prepare_inputs(sim, n_quanta)
    draws = draws if draws is not None else TorchDraws(sim.seed, sim.device)
    fetched, wall = _run_lanes(
        [sim], [prep], n_quanta, prep["j_pad"],
        (prep["syn_cost"], prep["syn_mean"], prep["syn_stacks"]), repeats,
        warmup, LaneDraws([draws]), telemetry=telemetry,
        app_telemetry=app_telemetry)
    with obs_trace.span("device_sim.stats"):
        return _lane_stats(sim, prep, n_quanta, fetched, 0,
                           wall / max(n_quanta, 1), telemetry=telemetry,
                           app_telemetry=app_telemetry)


def _attach_fault_stats(stats: OnlineStats, prep, retries, retry_at,
                        evictions, requeues) -> None:
    """Fill the fault timelines and scalars of a run's stats from the
    fetched job logs and the host-side fault schedule."""
    sched = prep["sched"]
    j = prep["j"]
    max_retries = prep["fcfg"][0]
    stats.failures = sched.failures()
    stats.recoveries = sched.recoveries()
    stats.straggling = sched.straggling()
    stats.evictions = np.asarray(evictions, np.float64)
    stats.requeues = np.asarray(requeues, np.float64)
    stats.n_dropped = int((retries[:j] > max_retries).sum()) if j else 0
    stats.n_retry_waiting = int(
        (retry_at[:j] < int(RETRY_NEVER)).sum()
    ) if j else 0
    # In flight = admitted but neither completed, dropped, nor waiting.
    stats.n_in_flight = (stats.n_admitted - stats.n_completed
                         - stats.n_dropped - stats.n_retry_waiting)


def _fingerprint(sim, n_quanta: int, seg_len: int, j_pad: int,
                 telemetry: bool, app_telemetry: bool) -> dict:
    """The configuration a snapshot must match to be resumed: the
    reference's fingerprint plus ``engine="torch"``, so that a snapshot of
    the other package is refused by it and not by a shape error."""
    return {
        "n_quanta": int(n_quanta), "seg_len": int(seg_len),
        "seed": int(sim.seed), "capacity": int(sim.capacity),
        "j_pad": int(j_pad), "admission": sim.admission,
        "kind": sim.policy.kind, "telemetry": bool(telemetry),
        "faulted": sim.faults is not None,
        "app_telemetry": bool(app_telemetry), "engine": "torch",
    }


def _checkpointed(sim, n_quanta: int, seg_len: int, ckpt_dir: str,
                  keep: int = 3, resume: bool = True,
                  telemetry: bool = False, app_telemetry: bool = False,
                  draws=None):
    """:func:`run_device_sim_checkpointed` up to its segment loop: the
    inputs committed and the state restored (or initial).  Returns
    ``loop(max_segments)``, which runs the remaining segments (each one
    device-to-host copy, counted in :data:`CKPT_SYNCS`, and one snapshot)
    and returns the stats, or None when it stopped at ``max_segments``."""
    from repro_torch.checkpoint import CheckpointManager

    telemetry = telemetry or app_telemetry
    if not (seg_len > 0 and n_quanta % seg_len == 0):
        raise AssertionError(
            f"horizon {n_quanta} must be a whole number of segments "
            f"(seg_len={seg_len}): padding jobs arrive at the horizon")
    prep = _prepare_inputs(sim, n_quanta)
    j_pad = prep["j_pad"]
    faulted = prep["fcfg"] is not None
    draws = draws if draws is not None else TorchDraws(sim.seed, sim.device)
    run = _grid_race([sim], [prep], seg_len, j_pad,
                     (prep["syn_cost"], prep["syn_mean"],
                      prep["syn_stacks"]), LaneDraws([draws]),
                     telemetry=telemetry, app_telemetry=app_telemetry,
                     segment=True)
    names = (_YS + (_FAULT_YS if faulted else ())
             + ("telemetry",) * telemetry
             + ("app_telemetry",) * app_telemetry)
    want = _fingerprint(sim, n_quanta, seg_len, j_pad, telemetry,
                        app_telemetry)
    mgr = CheckpointManager(ckpt_dir, keep=keep)
    # The state on the device, its host copy (a snapshot's tree) and the
    # per-quantum outputs so far, at quantum q0.
    state, tree, q0 = None, None, 0
    if resume:
        step, tree, meta = mgr.restore_latest()
        if step is not None:
            got = {k: meta.get(k) for k in want}
            if got != want:
                raise AssertionError(f"checkpoint config mismatch under "
                                     f"{ckpt_dir}: {got} vs {want}")
            # One copy to the device a resume, outside the loop.
            def on_device(cls, part):
                return cls(**{k: torch.as_tensor(v, device=sim.device)
                              for k, v in tree[part].items()})

            state = (on_device(_OpenCarry, "ocarry"),
                     on_device(_FaultCarry, "fcarry") if faulted else None)
            q0 = step

    def loop(max_segments: Optional[int] = None):
        global CKPT_SYNCS
        nonlocal state, tree, q0
        t0 = time.perf_counter()
        segs = 0
        while q0 < n_quanta:
            if max_segments is not None and segs >= max_segments:
                return None      # stopped on purpose; resume later
            with obs_trace.span("device_sim.dispatch", q0=q0,
                                segment=True):
                state, cols = run(state, q0)
                carried = [t for part in state if part is not None
                           for t in part]
                CKPT_SYNCS += 1
                host = _fetch_host(carried + cols)
            n_oc = len(_OpenCarry._fields)
            seg = host[len(carried):]
            ys = seg if tree is None else [
                np.concatenate([tree["ys"][nm], y], 1)
                for nm, y in zip(names, seg)]
            tree = {"ocarry": dict(zip(_OpenCarry._fields, host[:n_oc])),
                    "ys": dict(zip(names, ys))}
            if faulted:
                tree["fcarry"] = dict(zip(_FaultCarry._fields,
                                          host[n_oc:len(carried)]))
            q0 += seg_len
            segs += 1
            with obs_trace.span("device_sim.checkpoint", step=q0):
                mgr.save(q0, tree, meta=want)
        per_quantum = (time.perf_counter() - t0) / max(segs * seg_len, 1)
        host_state = (_OpenCarry(**tree["ocarry"]),
                      _FaultCarry(**tree["fcarry"]) if faulted else None)
        ys = [tree["ys"][nm] for nm in names]
        with obs_trace.span("device_sim.stats"):
            return _lane_stats(sim, prep, n_quanta,
                               run.unpack(host_state, ys), 0, per_quantum,
                               telemetry=telemetry,
                               app_telemetry=app_telemetry)

    return loop


def run_device_sim_checkpointed(sim, n_quanta: int, seg_len: int,
                                ckpt_dir: str, keep: int = 3,
                                resume: bool = True,
                                telemetry: bool = False,
                                app_telemetry: bool = False,
                                max_segments: Optional[int] = None,
                                draws=None) -> Optional[OnlineStats]:
    """:func:`run_device_sim` in ``n_quanta / seg_len`` segments, with a
    snapshot at every segment's end: the whole state, the fault state of
    a faulted run and the per-quantum outputs so far (rings included),
    written through :class:`repro_torch.checkpoint.CheckpointManager`
    (``keep`` newest kept) under ``ckpt_dir``.

    A run killed between segments resumes from its newest valid snapshot
    (corrupt or partial ones are skipped and removed) and ends bit for
    bit as the run left alone: the jobs and the fault schedule are
    functions of the seed, and the draws, the arrivals and the schedule
    are keyed by the quantum's index in the horizon.  The segments run the
    loop of :func:`run_device_sim`, whose finish log already lives in the
    state, so on one device the two are equal bit for bit, finish quanta
    included.

    Each segment adds one host round trip (the snapshot's single
    device-to-host copy, counted in :data:`CKPT_SYNCS`) to the loop's own.
    ``n_quanta`` must be a whole number of segments (padding jobs arrive
    at ``n_quanta``).  ``max_segments`` stops after that many segments
    this call and returns None; ``resume=False`` ignores existing
    snapshots; a snapshot of another configuration (or of the reference
    package) is refused with an ``AssertionError`` saying "mismatch".
    ``policy_s`` is the wall per quantum of this call's segments, the
    snapshots included.  ``draws`` defaults as in :func:`run_device_sim`.
    """
    loop = _checkpointed(sim, n_quanta, seg_len, ckpt_dir, keep=keep,
                         resume=resume, telemetry=telemetry,
                         app_telemetry=app_telemetry, draws=draws)
    return loop(max_segments)
