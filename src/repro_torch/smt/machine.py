"""Ground-truth SMT machine model + PMU counter generation (numpy).

The port's own copy of what the profiling campaign, the closed race and the
open system need from ``repro.smt.machine``: the machine constants, the
interference transform, the PMU counter model (scalar and batched), the
array view of a workload's profiles, solo runs, solo retire rates and §6.2
targets, and the fixed-horizon result record.

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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.smt.apps import AppProfile, Phase


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
) -> np.ndarray:
    """Batched :func:`pmu_readout`: (K, 4) comps -> (K, 5) counter rows."""
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
        out[:, 1:5] *= rng.lognormal(0.0, params.noise_sigma, size=(k, 4))
    return out


@dataclasses.dataclass
class _AppState:
    profile: AppProfile
    phase_idx: int = 0
    phase_left: float = 0.0         # quanta remaining in current phase

    def phase(self) -> Phase:
        return self.profile.phase(self.phase_idx)


class SMTMachine:
    """The machine's solo runs and §6.2 targets: what the profiling
    campaign and the open system's job targets need.

    The closed race runs in :mod:`repro_torch.smt.scan_engine`, the open
    system in :mod:`repro_torch.online.device_sim`.
    """

    def __init__(self, params: MachineParams = MachineParams(), seed: int = 0):
        self.params = params
        self.rng = np.random.default_rng(seed)
        self._solo_rate_cache: Dict[str, float] = {}

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

    def _advance_phase(self, st: _AppState, rng: np.random.Generator) -> None:
        st.phase_left -= 1.0
        if st.phase_left <= 0.0:
            st.phase_idx += 1
            dur = st.profile.phase(st.phase_idx).duration
            st.phase_left = float(max(1, rng.poisson(dur)))


def _ipc_geomean(ipc: np.ndarray) -> float:
    return float(np.exp(np.mean(np.log(np.maximum(ipc, 1e-12)))))


@dataclasses.dataclass
class ThroughputResult:
    """Fixed-horizon metrics of one policy in a cluster-scale race."""

    n_apps: int
    quanta: int
    ipc: np.ndarray                 # per-app IPC over the horizon
    total_retired: float            # machine-wide retired instructions
    mean_true_slowdown: float       # ground-truth pairing quality (lower=better)
    machine_s_per_quantum: float    # race wall-time per quantum (all policies)
    #: Per-quantum telemetry ring (``repro_torch.obs.telemetry.
    #: TelemetryLog``) when the race ran with ``telemetry=True``.
    telemetry: Optional[object] = None
    #: Per-application ring (``AppTelemetryLog``) when it ran with
    #: ``app_telemetry=True``.
    app_telemetry: Optional[object] = None

    @property
    def ipc_geomean(self) -> float:
        return _ipc_geomean(self.ipc)
