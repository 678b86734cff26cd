"""Ground-truth SMT machine model + PMU counter generation (numpy).

The port's copy of ``repro.smt.machine``: the machine executes workloads in
100 ms quanta on N 2-way SMT cores (two applications per core).  Per
quantum it asks the scheduling policy for a thread-to-core pairing,
advances every application by the instructions its *true* co-run CPI
allows, and emits per-application PMU counters with realistic
imperfections (multiplicative noise, FE/BE overlap, invisible horizontal
waste).  Two engines run a workload: ``engine="vector"`` (batched array
work over all N apps) and ``engine="loop"`` (the per-app reference loop);
they draw from the machine's ``np.random.Generator`` in the same order and
give bit-identical results.  The same numbers come out of the same seeds
as from the reference's machine.  The closed race on tensors runs in
:mod:`repro_torch.smt.scan_engine`, the open system's device engine in
:mod:`repro_torch.online.device_sim`.

Ground-truth interference model (policies never see this).  For application
*i* in phase ``p`` co-running with *j* in phase ``q``, the per-instruction
cycle components (cycles per dispatched instruction) transform as

    c_full' = c_full * (1 + aD  * U_j)                    dispatch-slot sharing
    c_hw'   = c_hw   * (1 + aHW * U_j)                    partial-fill pressure
    c_fe'   = c_fe   * (1 + aFE * F_j) + eFE * fsens_i * F_j * cpi_i
    c_be'   = c_be   * (1 + aBE * M_j + bBE * M_j^2)
                     + eBE * msens_i * M_j * cpi_i         LLC/DRAM contention

with U_j = dispatch-slot utilisation, F_j = frontend-stall fraction and
M_j = backend-stall fraction of the co-runner.  True slowdown of i next to
j = sum(c') / sum(c).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.smt.apps import AppProfile, Phase

Pair = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """Calibrated machine constants."""

    width: int = 4
    freq_hz: float = 2.2e9
    quantum_s: float = 0.1          # paper: 100 ms quanta
    # Interference coefficients (ground truth).
    a_disp: float = 0.30
    a_hw: float = 0.45
    a_fe: float = 1.30
    e_fe: float = 0.25
    a_be: float = 1.20
    b_be: float = 7.00
    e_be: float = 0.40
    # PMU imperfections.
    noise_sigma: float = 0.01       # multiplicative counter noise
    overlap_split: float = 0.5      # share of overlap count landing on FE
    # Methodology (paper §6.2, time-scaled 10x for simulation cost).
    solo_reference_s: float = 6.0

    @property
    def quantum_cycles(self) -> float:
        return self.freq_hz * self.quantum_s

    @property
    def solo_reference_quanta(self) -> int:
        return int(round(self.solo_reference_s / self.quantum_s))


@dataclasses.dataclass
class PMUSample:
    """Per-application, per-quantum PMU readout (paper Table 1)."""

    cpu_cycles: float
    stall_frontend: float
    stall_backend: float
    inst_spec: float
    inst_retired: float

    def as_tuple(self):
        return (
            self.cpu_cycles,
            self.stall_frontend,
            self.stall_backend,
            self.inst_spec,
            self.inst_retired,
        )


def _components_per_inst(phase: Phase) -> np.ndarray:
    """Solo per-instruction cycle components (c_full, c_hw, c_fe, c_be)."""
    cpi = 1.0 / max(phase.ipc_spec, 1e-9)
    return np.array(
        [phase.x_full * cpi, phase.x_hw * cpi, phase.x_fe * cpi, phase.x_be * cpi]
    )


def corun_components(
    phase_i: Phase,
    app_i: AppProfile,
    phase_j: Optional[Phase],
    params: MachineParams,
) -> np.ndarray:
    """Ground-truth per-instruction cycle components of i next to j.

    ``phase_j is None`` means single-threaded execution (no co-runner).
    """
    c = _components_per_inst(phase_i)
    if phase_j is None:
        return c
    cpi = float(c.sum())
    u, f, m = phase_j.util, phase_j.x_fe, phase_j.x_be
    out = np.empty(4)
    out[0] = c[0] * (1.0 + params.a_disp * u)
    out[1] = c[1] * (1.0 + params.a_hw * u)
    out[2] = c[2] * (1.0 + params.a_fe * f) + params.e_fe * app_i.fetch_sens * f * cpi
    out[3] = (
        c[3] * (1.0 + params.a_be * m + params.b_be * app_i.mem_sens * m * m)
        + params.e_be * app_i.mem_sens * m * cpi
    )
    return out


def true_slowdown(
    phase_i: Phase, app_i: AppProfile, phase_j: Phase, params: MachineParams
) -> float:
    """Oracle slowdown of i when co-scheduled with j (>= 1)."""
    solo = _components_per_inst(phase_i).sum()
    smt = corun_components(phase_i, app_i, phase_j, params).sum()
    return float(smt / solo)


def pmu_readout(
    comps: np.ndarray,
    app: AppProfile,
    phase: Phase,
    cycles: float,
    params: MachineParams,
    rng: np.random.Generator,
    noisy: bool = True,
) -> PMUSample:
    """Generate the five PMU counters for ``cycles`` cycles of execution.

    Horizontal waste is invisible to INST_SPEC (-> LT100 stacks), and FE/BE
    stall conditions overlapping in a cycle tick both counters:
    ``omega * min(fe, be)`` extra counts split across the two events
    (-> GT100 stacks for high-omega applications).
    """
    cpi = float(comps.sum())
    insts = cycles / cpi
    frac = comps / cpi
    x_fe, x_be = float(frac[2]), float(frac[3])
    overlap = app.omega * min(x_fe, x_be)

    def nz(v: float) -> float:
        if not noisy:
            return v
        return v * float(rng.lognormal(0.0, params.noise_sigma))

    stall_fe = nz(cycles * (x_fe + params.overlap_split * overlap))
    stall_be = nz(cycles * (x_be + (1.0 - params.overlap_split) * overlap))
    inst_spec = nz(insts)
    inst_ret = nz(insts * app.retire)
    return PMUSample(
        cpu_cycles=cycles,
        stall_frontend=stall_fe,
        stall_backend=stall_be,
        inst_spec=inst_spec,
        inst_retired=inst_ret,
    )


@dataclasses.dataclass(frozen=True)
class PhaseTables:
    """Array view of a workload's profiles for batched quantum computation.

    Per-phase attributes are padded to the longest phase list and always
    indexed with ``phase_idx % n_phases[app]``, mirroring
    ``AppProfile.phase``.
    """

    n_apps: int
    n_phases: np.ndarray      # (A,) int
    comps: np.ndarray         # (A, Pmax, 4) solo per-instruction cycle comps
    util: np.ndarray          # (A, Pmax) dispatch-slot utilisation
    x_fe: np.ndarray          # (A, Pmax) frontend-stall fraction
    x_be: np.ndarray          # (A, Pmax) backend-stall fraction
    duration: np.ndarray      # (A, Pmax) mean phase duration (quanta)
    omega: np.ndarray         # (A,)
    retire: np.ndarray        # (A,)
    mem_sens: np.ndarray      # (A,)
    fetch_sens: np.ndarray    # (A,)

    @classmethod
    def build(cls, profiles: Sequence[AppProfile]) -> "PhaseTables":
        a = len(profiles)
        pmax = max(len(p.phases) for p in profiles)
        n_phases = np.array([len(p.phases) for p in profiles], np.int64)
        comps = np.zeros((a, pmax, 4))
        util = np.zeros((a, pmax))
        x_fe = np.zeros((a, pmax))
        x_be = np.zeros((a, pmax))
        duration = np.zeros((a, pmax))
        for ai, p in enumerate(profiles):
            for pi, ph in enumerate(p.phases):
                comps[ai, pi] = _components_per_inst(ph)
                util[ai, pi] = ph.util
                x_fe[ai, pi] = ph.x_fe
                x_be[ai, pi] = ph.x_be
                duration[ai, pi] = float(ph.duration)
        return cls(
            n_apps=a,
            n_phases=n_phases,
            comps=comps,
            util=util,
            x_fe=x_fe,
            x_be=x_be,
            duration=duration,
            omega=np.array([p.omega for p in profiles]),
            retire=np.array([p.retire for p in profiles]),
            mem_sens=np.array([p.mem_sens for p in profiles]),
            fetch_sens=np.array([p.fetch_sens for p in profiles]),
        )


def corun_components_batched(
    tables: PhaseTables,
    idx_i: np.ndarray,
    ph_i: np.ndarray,
    idx_j: Optional[np.ndarray],
    ph_j: Optional[np.ndarray],
    params: MachineParams,
) -> np.ndarray:
    """Batched :func:`corun_components`: (K,) index arrays -> (K, 4) comps."""
    c = tables.comps[idx_i, ph_i]
    if idx_j is None:
        return c.copy()
    cpi = c.sum(axis=-1)
    u = tables.util[idx_j, ph_j]
    f = tables.x_fe[idx_j, ph_j]
    m = tables.x_be[idx_j, ph_j]
    mem = tables.mem_sens[idx_i]
    fetch = tables.fetch_sens[idx_i]
    out = np.empty_like(c)
    out[:, 0] = c[:, 0] * (1.0 + params.a_disp * u)
    out[:, 1] = c[:, 1] * (1.0 + params.a_hw * u)
    out[:, 2] = c[:, 2] * (1.0 + params.a_fe * f) + params.e_fe * fetch * f * cpi
    out[:, 3] = (
        c[:, 3] * (1.0 + params.a_be * m + params.b_be * mem * m * m)
        + params.e_be * mem * m * cpi
    )
    return out


def pmu_counters_batched(
    comps: np.ndarray,
    omega: np.ndarray,
    retire: np.ndarray,
    cycles: float,
    params: MachineParams,
    rng: np.random.Generator,
    noisy: bool = True,
    draw_order: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Batched :func:`pmu_readout`: (K, 4) comps -> (K, 5) counter rows.

    ``draw_order`` fixes which app consumes which noise draw; passing the
    scalar loop's visit order makes the batched counters bit-identical.
    """
    k = comps.shape[0]
    cpi = comps.sum(axis=-1)
    insts = cycles / cpi
    frac = comps / cpi[:, None]
    x_fe, x_be = frac[:, 2], frac[:, 3]
    overlap = omega * np.minimum(x_fe, x_be)
    out = np.empty((k, 5))
    out[:, 0] = cycles
    out[:, 1] = cycles * (x_fe + params.overlap_split * overlap)
    out[:, 2] = cycles * (x_be + (1.0 - params.overlap_split) * overlap)
    out[:, 3] = insts
    out[:, 4] = insts * retire
    if noisy:
        draws = rng.lognormal(0.0, params.noise_sigma, size=(k, 4))
        if draw_order is not None:
            noise = np.empty_like(draws)
            noise[draw_order] = draws
        else:
            noise = draws
        out[:, 1:5] *= noise
    return out


@dataclasses.dataclass
class _AppState:
    profile: AppProfile
    phase_idx: int = 0
    phase_left: float = 0.0         # quanta remaining in current phase
    progress: float = 0.0           # retired instructions, current launch
    target: float = 0.0             # retired-instruction target (§6.2)
    first_finish_q: float = math.inf  # quantum index (fractional) of 1st finish
    launches: int = 0
    total_retired: float = 0.0
    total_cycles: float = 0.0

    def phase(self) -> Phase:
        return self.profile.phase(self.phase_idx)


@dataclasses.dataclass
class _VectorState:
    """Array-of-struct counterpart of ``_AppState`` for the batched engine."""

    phase_idx: np.ndarray
    phase_left: np.ndarray
    progress: np.ndarray
    target: np.ndarray
    first_finish_q: np.ndarray
    launches: np.ndarray
    total_retired: np.ndarray
    total_cycles: np.ndarray

    @classmethod
    def init(cls, tables: PhaseTables, targets: np.ndarray) -> "_VectorState":
        n = tables.n_apps
        return cls(
            phase_idx=np.zeros(n, np.int64),
            phase_left=tables.duration[:, 0].copy(),
            progress=np.zeros(n),
            target=np.asarray(targets, np.float64),
            first_finish_q=np.full(n, np.inf),
            launches=np.zeros(n, np.int64),
            total_retired=np.zeros(n),
            total_cycles=np.zeros(n),
        )

    @classmethod
    def empty(cls, n_slots: int) -> "_VectorState":
        """Blank per-slot state for the open system (``repro_torch.online``).

        Slots are populated incrementally as applications are admitted; the
        simulator owns per-slot (re)initialisation on admission/departure.
        """
        return cls(
            phase_idx=np.zeros(n_slots, np.int64),
            phase_left=np.zeros(n_slots),
            progress=np.zeros(n_slots),
            target=np.full(n_slots, np.inf),
            first_finish_q=np.full(n_slots, np.inf),
            launches=np.zeros(n_slots, np.int64),
            total_retired=np.zeros(n_slots),
            total_cycles=np.zeros(n_slots),
        )


class SMTMachine:
    """Discrete-quantum simulator of an N-core, 2-way-SMT processor."""

    def __init__(self, params: MachineParams = MachineParams(), seed: int = 0):
        self.params = params
        self.rng = np.random.default_rng(seed)
        self._solo_rate_cache: Dict[str, float] = {}

    # ------------------------------------------------------------------ solo
    def run_solo(
        self,
        profile: AppProfile,
        quanta: int,
        noisy: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[List[PMUSample], List[int]]:
        """Run an application alone; return per-quantum samples + phase ids."""
        rng = rng or self.rng
        st = _AppState(profile=profile)
        st.phase_left = profile.phase(0).duration
        samples: List[PMUSample] = []
        phases: List[int] = []
        for _ in range(quanta):
            ph = st.phase()
            comps = corun_components(ph, profile, None, self.params)
            samples.append(
                pmu_readout(
                    comps, profile, ph, self.params.quantum_cycles, self.params,
                    rng, noisy,
                )
            )
            phases.append(st.phase_idx % len(profile.phases))
            self._advance_phase(st, rng)
        return samples, phases

    def solo_retire_rate(self, profile: AppProfile) -> float:
        """Average retired instructions per quantum in solo execution."""
        if profile.name not in self._solo_rate_cache:
            total, weight = 0.0, 0.0
            for ph in profile.phases:
                comps = _components_per_inst(ph)
                rate = self.params.quantum_cycles / comps.sum() * profile.retire
                total += rate * ph.duration
                weight += ph.duration
            self._solo_rate_cache[profile.name] = total / weight
        return self._solo_rate_cache[profile.name]

    def target_instructions(self, profile: AppProfile) -> float:
        """§6.2: instructions committed in the solo reference period."""
        return self.solo_retire_rate(profile) * self.params.solo_reference_quanta

    # ------------------------------------------------------------ workload
    def run_workload(
        self,
        profiles: Sequence[AppProfile],
        policy,
        seed: int = 0,
        max_quanta: int = 5000,
        engine: str = "vector",
    ) -> "WorkloadResult":
        """Run a workload under ``policy`` until every app reaches its target.

        Implements the paper's §6.2 methodology: targets from the solo
        reference run; early finishers are relaunched so the machine load is
        constant; the run ends when the *slowest first launch* completes.

        ``engine="vector"`` (default) runs each quantum as a batched array
        computation over all N apps; ``engine="loop"`` is the original
        per-app reference loop.  Both consume the RNG stream identically and
        produce bit-identical results.
        """
        if engine == "vector":
            return self._run_workload_vector(profiles, policy, seed, max_quanta)
        assert engine == "loop", engine
        n = len(profiles)
        assert n % 2 == 0, "need an even number of applications"
        rng = np.random.default_rng(seed)
        states = []
        for p in profiles:
            st = _AppState(profile=p, target=self.target_instructions(p))
            st.phase_left = p.phase(0).duration
            states.append(st)

        policy.reset(n_apps=n, rng=np.random.default_rng(seed + 7919), machine=self)
        self._active_states = states  # exposed only for the Oracle baseline
        self._vector_ctx = None
        samples: List[Optional[PMUSample]] = [None] * n
        pairs: List[Pair] = []
        q = 0
        while q < max_quanta and any(math.isinf(s.first_finish_q) for s in states):
            pairs = policy.schedule(q, samples, pairs)
            assert sorted(x for p2 in pairs for x in p2) == list(range(n))
            new_samples: List[Optional[PMUSample]] = [None] * n
            for (i, j) in pairs:
                for (a, b) in ((i, j), (j, i)):
                    st, co = states[a], states[b]
                    comps = corun_components(
                        st.phase(), st.profile, co.phase(), self.params
                    )
                    cpi = comps.sum()
                    retired = (
                        self.params.quantum_cycles / cpi * st.profile.retire
                    )
                    before = st.progress
                    st.progress += retired
                    st.total_retired += retired
                    st.total_cycles += self.params.quantum_cycles
                    if math.isinf(st.first_finish_q) and st.progress >= st.target:
                        frac = (st.target - before) / max(retired, 1e-9)
                        st.first_finish_q = q + min(max(frac, 0.0), 1.0)
                    if st.progress >= st.target:
                        # Relaunch (constant machine load, §6.2).
                        st.progress -= st.target
                        st.launches += 1
                        st.phase_idx = 0
                        st.phase_left = st.profile.phase(0).duration
                    new_samples[a] = pmu_readout(
                        comps, st.profile, st.phase(),
                        self.params.quantum_cycles, self.params, rng,
                    )
            for st in states:
                self._advance_phase(st, rng)
            samples = new_samples
            q += 1

        tt = np.array(
            [
                min(s.first_finish_q, float(max_quanta)) * self.params.quantum_s
                for s in states
            ]
        )
        solo_tt = np.array(
            [
                s.target / self.solo_retire_rate(s.profile) * self.params.quantum_s
                for s in states
            ]
        )
        # Whole-run IPC (includes relaunches): a throughput metric that can
        # move opposite to turnaround time, as the paper observes for CFS.
        ipc = np.array(
            [s.total_retired / max(s.total_cycles, 1.0) for s in states]
        )
        return WorkloadResult(
            app_names=[s.profile.name for s in states],
            turnaround_s=tt,
            solo_turnaround_s=solo_tt,
            ipc=ipc,
            quanta=q,
            completed=all(not math.isinf(s.first_finish_q) for s in states),
        )

    # ------------------------------------------------- vectorised workload
    def _run_workload_vector(
        self,
        profiles: Sequence[AppProfile],
        policy,
        seed: int,
        max_quanta: int,
    ) -> "WorkloadResult":
        n = len(profiles)
        assert n % 2 == 0, "need an even number of applications"
        rng = np.random.default_rng(seed)
        tables = PhaseTables.build(profiles)
        targets = np.array([self.target_instructions(p) for p in profiles])
        st = _VectorState.init(tables, targets)

        policy.reset(n_apps=n, rng=np.random.default_rng(seed + 7919), machine=self)
        self._active_states = None
        self._vector_ctx = (tables, st)
        try:
            samples: List[Optional[PMUSample]] = [None] * n
            pairs: List[Pair] = []
            q = 0
            while q < max_quanta and np.isinf(st.first_finish_q).any():
                pairs = policy.schedule(q, samples, pairs)
                pa = np.asarray(pairs, dtype=np.int64)
                assert pa.shape == (n // 2, 2) and np.array_equal(
                    np.sort(pa.ravel()), np.arange(n)
                ), "policy must return a perfect pairing"
                # Policies receive the raw (N, 5) counter matrix; the scalar
                # engine passes a list of PMUSample — schedulers accept both.
                samples = self._vector_quantum(tables, st, pa, rng, q)
                self._advance_phases_vector(tables, st, rng)
                q += 1
        finally:
            self._vector_ctx = None

        tt = np.minimum(st.first_finish_q, float(max_quanta)) * self.params.quantum_s
        solo_tt = np.array(
            [
                t / self.solo_retire_rate(p) * self.params.quantum_s
                for t, p in zip(targets, profiles)
            ]
        )
        ipc = st.total_retired / np.maximum(st.total_cycles, 1.0)
        return WorkloadResult(
            app_names=[p.name for p in profiles],
            turnaround_s=tt,
            solo_turnaround_s=solo_tt,
            ipc=ipc,
            quanta=q,
            completed=bool(np.isfinite(st.first_finish_q).all()),
        )

    def _vector_quantum(
        self,
        tables: PhaseTables,
        st: _VectorState,
        pairs: np.ndarray,
        rng: np.random.Generator,
        q: int,
        solo: int = -1,
    ) -> np.ndarray:
        """Advance every app by one quantum; return the (N, 5) PMU counters.

        The scalar loop updates each pair's first thread before computing the
        second thread's components, so a relaunch of the first thread resets
        the phase its partner sees *within the same quantum*; the two-step
        split below reproduces that ordering exactly.

        ``solo`` (odd populations) names the slot running alone on its core
        this quantum: it executes interference-free and, by convention,
        consumes its noise draw last (after every paired app).
        """
        n = tables.n_apps
        firsts, seconds = pairs[:, 0], pairs[:, 1]
        ph_pre = st.phase_idx % tables.n_phases
        comps = np.empty((n, 4))
        comps[firsts] = corun_components_batched(
            tables, firsts, ph_pre[firsts], seconds, ph_pre[seconds], self.params
        )
        self._apply_progress(tables, st, firsts, comps[firsts], q)
        ph_mid = st.phase_idx % tables.n_phases
        comps[seconds] = corun_components_batched(
            tables, seconds, ph_pre[seconds], firsts, ph_mid[firsts], self.params
        )
        self._apply_progress(tables, st, seconds, comps[seconds], q)
        draw_order = pairs.ravel()
        if solo >= 0:
            sidx = np.array([solo], np.int64)
            comps[sidx] = corun_components_batched(
                tables, sidx, ph_pre[sidx], None, None, self.params
            )
            self._apply_progress(tables, st, sidx, comps[sidx], q)
            draw_order = np.concatenate([draw_order, sidx])
        return pmu_counters_batched(
            comps, tables.omega, tables.retire, self.params.quantum_cycles,
            self.params, rng, noisy=True, draw_order=draw_order,
        )

    def _apply_progress(
        self,
        tables: PhaseTables,
        st: _VectorState,
        idx: np.ndarray,
        comps: np.ndarray,
        q: int,
    ) -> None:
        """Instruction advance + §6.2 finish/relaunch bookkeeping for ``idx``."""
        cpi = comps.sum(axis=-1)
        retired = self.params.quantum_cycles / cpi * tables.retire[idx]
        before = st.progress[idx]
        after = before + retired
        st.total_retired[idx] += retired
        st.total_cycles[idx] += self.params.quantum_cycles
        target = st.target[idx]
        done = after >= target
        newly = np.isinf(st.first_finish_q[idx]) & done
        if newly.any():
            frac = (target[newly] - before[newly]) / np.maximum(
                retired[newly], 1e-9
            )
            st.first_finish_q[idx[newly]] = q + np.clip(frac, 0.0, 1.0)
        if done.any():
            # Relaunch (constant machine load, §6.2).
            ridx = idx[done]
            after[done] -= target[done]
            st.launches[ridx] += 1
            st.phase_idx[ridx] = 0
            st.phase_left[ridx] = tables.duration[ridx, 0]
        st.progress[idx] = after

    def _advance_phases_vector(
        self, tables: PhaseTables, st: _VectorState, rng: np.random.Generator
    ) -> None:
        st.phase_left -= 1.0
        (done,) = np.nonzero(st.phase_left <= 0.0)
        for k in done:  # ascending order matches the scalar loop's rng draws
            st.phase_idx[k] += 1
            lam = tables.duration[k, st.phase_idx[k] % tables.n_phases[k]]
            st.phase_left[k] = float(max(1, rng.poisson(lam)))

    def oracle_cost_matrix(self) -> Optional[np.ndarray]:
        """Ground-truth symmetric pair-cost matrix of the *running* workload.

        Only available while the vectorised engine is mid-run (the Oracle
        baseline's cheat path); returns None otherwise.
        """
        ctx = getattr(self, "_vector_ctx", None)
        if ctx is None:
            return None
        tables, st = ctx
        n = tables.n_apps
        ph = st.phase_idx % tables.n_phases
        idx = np.arange(n)
        ii = np.repeat(idx, n)
        jj = np.tile(idx, n)
        comps = corun_components_batched(
            tables, ii, ph[ii], jj, ph[jj], self.params
        )
        solo = tables.comps[idx, ph].sum(axis=-1)
        slow = comps.sum(axis=-1).reshape(n, n) / solo[:, None]
        sym = slow + slow.T
        np.fill_diagonal(sym, 1e9)
        return sym

    # ------------------------------------------------- open-system quantum
    def open_quantum(
        self,
        tables: PhaseTables,
        app_id: np.ndarray,
        st: _VectorState,
        pairs: np.ndarray,
        solo: np.ndarray,
        rng: np.random.Generator,
        q: int,
        speed: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One quantum of an *open* system (the host engine of
        ``repro_torch.online.sim``).

        Unlike the closed-system quantum, membership is masked: only the
        slots named by ``pairs``/``solo`` execute, applications that reach
        their retired-instruction target *depart* (no §6.2 relaunch), and an
        odd population leaves one application on a core with an idle second
        context (``solo``), where it runs interference-free.

        tables:  :class:`PhaseTables` of the application *pool*;
        app_id:  (C,) pool row occupying each slot (-1 = empty slot);
        st:      per-slot :class:`_VectorState`; ``target`` holds absolute
                 retired-instruction targets (departure, not relaunch);
        pairs:   (K, 2) slot pairs sharing a core this quantum;
        solo:    (S,) slots running alone this quantum;
        speed:   optional (C,) per-slot capability multiplier (straggler
                 cores, ``repro_torch.online.faults``): retired instructions
                 scale by it, PMU counters and interference do not — the
                 model is a clock-throttled core.  ``None`` (the default)
                 is the nominal machine, not a multiply-by-one.

        Returns ``(counters, finished)``: the (C, 5) PMU counter matrix
        (rows of inactive slots are zero) and a (C,) bool mask of slots whose
        application reached its target this quantum (``first_finish_q`` is
        set to the fractional completion quantum; the caller frees the slot).

        Determinism convention: counter-noise draws and phase-advance
        poisson draws are consumed in ascending slot order, so a run is a
        pure function of (workload, arrivals, policy, seed).
        """
        n_slots = app_id.shape[0]
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        solo = np.asarray(solo, np.int64).reshape(-1)
        active = np.sort(np.concatenate([pairs.ravel(), solo]))
        assert active.size == np.unique(active).size, "slot scheduled twice"
        assert active.size == 0 or (
            active[0] >= 0 and active[-1] < n_slots
        ), "slot index out of range"
        assert (app_id[active] >= 0).all(), "scheduled an empty slot"
        counters = np.zeros((n_slots, 5))
        finished = np.zeros(n_slots, bool)
        if active.size == 0:
            return counters, finished

        aid = app_id[active]
        comps = np.empty((n_slots, 4))
        if pairs.size:
            a, b = pairs[:, 0], pairs[:, 1]
            ph_a = st.phase_idx[a] % tables.n_phases[app_id[a]]
            ph_b = st.phase_idx[b] % tables.n_phases[app_id[b]]
            comps[a] = corun_components_batched(
                tables, app_id[a], ph_a, app_id[b], ph_b, self.params
            )
            comps[b] = corun_components_batched(
                tables, app_id[b], ph_b, app_id[a], ph_a, self.params
            )
        if solo.size:
            ph_s = st.phase_idx[solo] % tables.n_phases[app_id[solo]]
            comps[solo] = corun_components_batched(
                tables, app_id[solo], ph_s, None, None, self.params
            )

        # Instruction advance + departure bookkeeping (no relaunch).
        cpi = comps[active].sum(axis=-1)
        retired = self.params.quantum_cycles / cpi * tables.retire[aid]
        if speed is not None:
            retired = retired * np.asarray(speed, np.float64)[active]
        before = st.progress[active]
        after = before + retired
        st.progress[active] = after
        st.total_retired[active] += retired
        st.total_cycles[active] += self.params.quantum_cycles
        done = after >= st.target[active]
        if done.any():
            d_slots = active[done]
            frac = (st.target[active][done] - before[done]) / np.maximum(
                retired[done], 1e-9
            )
            st.first_finish_q[d_slots] = q + np.clip(frac, 0.0, 1.0)
            finished[d_slots] = True

        counters[active] = pmu_counters_batched(
            comps[active], tables.omega[aid], tables.retire[aid],
            self.params.quantum_cycles, self.params, rng, noisy=True,
        )

        # Phase advance for survivors only (departed apps leave at quantum
        # end); poisson draws happen per transitioning slot, ascending.
        survivors = active[~done]
        st.phase_left[survivors] -= 1.0
        (idx,) = np.nonzero(st.phase_left[survivors] <= 0.0)
        for k in survivors[idx]:
            st.phase_idx[k] += 1
            pid = app_id[k]
            lam = tables.duration[pid, st.phase_idx[k] % tables.n_phases[pid]]
            st.phase_left[k] = float(max(1, rng.poisson(lam)))
        return counters, finished

    # ------------------------------------------------- fixed-horizon mode
    def run_quanta(
        self,
        profiles: Sequence[AppProfile],
        policy,
        n_quanta: int = 20,
        seed: int = 0,
        tables: Optional[PhaseTables] = None,
    ) -> "ThroughputResult":
        """Run exactly ``n_quanta`` quanta (no §6.2 targets) — throughput mode.

        The cluster-scale scenario uses this to race policies at N in the
        thousands, where running every app to its solo-reference target would
        take hours.  Reports aggregate IPC, the mean true slowdown of the
        chosen pairings, and scheduling/machine wall-times per quantum.

        Odd populations follow the idle-context convention of the open
        system (``repro_torch.online``): the policy returns ``(n - 1) // 2``
        pairs and the uncovered application runs alone on its core —
        interference-free, slowdown 1 — that quantum.  Closed and open
        systems therefore accept the same workloads.

        ``tables`` lets callers share one :class:`PhaseTables` build across
        several runs of the same workload (see :meth:`run_quanta_multi`).
        """
        n = len(profiles)
        rng = np.random.default_rng(seed)
        tables = tables if tables is not None else PhaseTables.build(profiles)
        assert tables.n_apps == n, "tables do not match the workload"
        st = _VectorState.init(tables, np.full(n, np.inf))

        policy.reset(n_apps=n, rng=np.random.default_rng(seed + 7919), machine=self)
        self._active_states = None
        self._vector_ctx = (tables, st)
        sched_s = 0.0
        sched_each: List[float] = []
        machine_s = 0.0
        slowdown_sum = 0.0
        try:
            samples: List[Optional[PMUSample]] = [None] * n
            pairs: List[Pair] = []
            for q in range(n_quanta):
                t0 = time.perf_counter()
                with obs_trace.span("machine.schedule", q=q):
                    pairs = policy.schedule(q, samples, pairs)
                t1 = time.perf_counter()
                sched_s += t1 - t0
                sched_each.append(t1 - t0)
                pa = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
                covered = np.sort(pa.ravel())
                assert pa.shape == (n // 2, 2) and np.unique(
                    covered
                ).size == covered.size and (
                    covered >= 0
                ).all() and (covered < n).all(), (
                    "policy must return a perfect pairing"
                )
                solo = -1
                if n % 2 == 1:
                    (uncov,) = np.nonzero(
                        ~np.isin(np.arange(n), covered)
                    )
                    assert uncov.size == 1
                    solo = int(uncov[0])
                else:
                    assert covered.size == n, (
                        "policy must cover every application"
                    )
                # Ground-truth mean slowdown of the chosen pairing (the
                # quality signal the race compares across policies); the
                # solo slot of an odd population contributes slowdown 1.
                ph = st.phase_idx % tables.n_phases
                partner = np.arange(n, dtype=np.int64)
                partner[pa[:, 0]] = pa[:, 1]
                partner[pa[:, 1]] = pa[:, 0]
                idx = np.arange(n)
                co = partner != idx
                smt = tables.comps[idx, ph].sum(axis=-1)
                if co.any():
                    smt[co] = corun_components_batched(
                        tables, idx[co], ph[co], partner[co],
                        ph[partner[co]], self.params
                    ).sum(axis=-1)
                solo_cpi = tables.comps[idx, ph].sum(axis=-1)
                slowdown_sum += float(np.mean(smt / solo_cpi))
                with obs_trace.span("machine.quantum", q=q):
                    samples = self._vector_quantum(tables, st, pa, rng, q,
                                                   solo=solo)
                    self._advance_phases_vector(tables, st, rng)
                machine_s += time.perf_counter() - t1
        finally:
            self._vector_ctx = None

        ipc = st.total_retired / np.maximum(st.total_cycles, 1.0)
        return ThroughputResult(
            n_apps=n,
            quanta=n_quanta,
            ipc=ipc,
            total_retired=float(st.total_retired.sum()),
            mean_true_slowdown=slowdown_sum / max(n_quanta, 1),
            sched_s_per_quantum=sched_s / max(n_quanta, 1),
            sched_s_per_quantum_median=float(np.median(sched_each))
            if sched_each else 0.0,
            machine_s_per_quantum=machine_s / max(n_quanta, 1),
        )

    def run_quanta_multi(
        self,
        profiles: Sequence[AppProfile],
        policies: Dict[str, "Callable[[], object]"],
        n_quanta: int = 20,
        seed: int = 0,
        engine: str = "vector",
        **scan_kwargs,
    ) -> Dict[str, "ThroughputResult"]:
        """Race K policies through one workload — one machine pass per policy.

        The expensive workload setup (the Python-loop :meth:`PhaseTables.build`
        over all N profiles, plus the solo-rate caches) is done once and
        shared; every policy then runs with the machine RNG reset to the same
        ``seed``, so all K passes face a bit-identical workload (same phase
        transitions, same counter noise for identical pairings) and their
        metrics differ only through the pairings each policy chose.

        ``engine="scan"`` runs the whole K-policy race on tensors
        (:func:`repro_torch.smt.scan_engine.run_quanta_scan`): the machine
        quantum, the fused SYNPA step and the device matcher per quantum.
        ``policies`` must then map names to
        :class:`repro_torch.smt.scan_engine.ScanPolicy` specs (not
        factories); ``scan_kwargs`` (``device``, ``draws``, ``repeats``,
        ``telemetry``, ``app_telemetry``) pass through.  That engine draws
        its noise from ``torch`` generators, not from this machine's
        stream.
        """
        if engine == "scan":
            from repro_torch.smt import scan_engine

            return scan_engine.run_quanta_scan(
                self.params, profiles, policies, n_quanta=n_quanta,
                seed=seed, **scan_kwargs,
            )
        tables = PhaseTables.build(profiles)
        assert engine == "vector", engine
        return {
            name: self.run_quanta(
                profiles, factory(), n_quanta=n_quanta, seed=seed,
                tables=tables,
            )
            for name, factory in policies.items()
        }

    # ------------------------------------------------------------------ misc
    def _advance_phase(self, st: _AppState, rng: np.random.Generator) -> None:
        st.phase_left -= 1.0
        if st.phase_left <= 0.0:
            st.phase_idx += 1
            dur = st.profile.phase(st.phase_idx).duration
            st.phase_left = float(max(1, rng.poisson(dur)))


def _ipc_geomean(ipc: np.ndarray) -> float:
    return float(np.exp(np.mean(np.log(np.maximum(ipc, 1e-12)))))


@dataclasses.dataclass
class WorkloadResult:
    app_names: List[str]
    turnaround_s: np.ndarray        # per-app turnaround time (first launch)
    solo_turnaround_s: np.ndarray   # per-app solo reference time
    ipc: np.ndarray                 # per-app IPC over its first launch
    quanta: int
    completed: bool

    @property
    def avg_turnaround_s(self) -> float:
        return float(self.turnaround_s.mean())

    @property
    def makespan_s(self) -> float:
        return float(self.turnaround_s.max())

    @property
    def ipc_geomean(self) -> float:
        return _ipc_geomean(self.ipc)


@dataclasses.dataclass
class ThroughputResult:
    """Fixed-horizon metrics of one policy in a cluster-scale race."""

    n_apps: int
    quanta: int
    ipc: np.ndarray                 # per-app IPC over the horizon
    total_retired: float            # machine-wide retired instructions
    mean_true_slowdown: float       # ground-truth pairing quality (lower=better)
    machine_s_per_quantum: float    # race wall-time per quantum (all policies)
    #: The host race (:meth:`SMTMachine.run_quanta`): mean and median
    #: policy wall-time per quantum (the scan engine's policy time is
    #: inside ``machine_s_per_quantum``, so it leaves these at 0).
    sched_s_per_quantum: float = 0.0
    sched_s_per_quantum_median: float = 0.0
    #: Per-quantum telemetry ring (``repro_torch.obs.telemetry.
    #: TelemetryLog``) when the race ran with ``telemetry=True``.
    telemetry: Optional[object] = None
    #: Per-application ring (``AppTelemetryLog``) when it ran with
    #: ``app_telemetry=True``.
    app_telemetry: Optional[object] = None

    @property
    def ipc_geomean(self) -> float:
        return _ipc_geomean(self.ipc)
