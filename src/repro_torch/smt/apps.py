"""SPEC-CPU-like application profiles for the simulated ThunderX2.

Each application is described by the *ground-truth* cycle composition of its
phases at the dispatch stage of a 4-wide SMT core, per cycle executed alone:

    x_full  fraction of cycles dispatching a full group (4 slots)
    x_hw    fraction of cycles dispatching 1..3 slots  (horizontal waste)
    x_fe    fraction of cycles stalled with an empty dispatch queue (frontend)
    x_be    fraction of cycles stalled on backend resources (ROB/mem/FUs)
    fill    average fraction of slots consumed in x_hw cycles (0.25..0.75)

plus PMU/interference character:

    omega       event-overlap propensity: in cycles where both FE and BE stall
                conditions hold, *both* counters tick; the overlapping count is
                omega * min(x_fe, x_be) split evenly between the two events.
                High omega => the measured stack exceeds 100% (case GT100).
    retire      INST_RETIRED / INST_SPEC (1 - bad-speculation fraction).
    mem_sens    sensitivity to a co-runner's memory pressure (LLC/DRAM).
    fetch_sens  sensitivity to a co-runner's fetch pressure (L1I/BTB).

The numbers are hand-calibrated so the *measured* stacks reproduce the
paper's Figure 2 landscape: 21/28 apps LT100, 7/28 GT100, ``mcf_r`` exceeding
by ~15%, and ``cactuBSSN_r``/``lbm_r``/``milc`` with 35-40% non-accounted
(horizontal-waste) cycles.  Profile values are plausible for the named
benchmarks but are *not* measurements of real hardware (see DESIGN.md §2).

Six applications are reserved for model assessment, never used to train the
Eq. 4 model (paper §5.4): imagick_r, parest_r, leela_r, wrf_r, cam4_r,
exchange2_r.  The workload pool (paper §6.2) contains 24 apps: 18 training
apps + the 6 reserved ones.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Phase:
    """Ground-truth cycle composition of one execution phase (solo)."""

    x_fe: float
    x_be: float
    x_hw: float
    fill: float
    duration: int  # mean duration in 100ms quanta before moving on

    @property
    def x_full(self) -> float:
        return max(1.0 - self.x_fe - self.x_be - self.x_hw, 0.0)

    @property
    def ipc_spec(self) -> float:
        """Speculative (dispatched) instructions per cycle, solo."""
        return 4.0 * (self.x_full + self.fill * self.x_hw)

    @property
    def util(self) -> float:
        """Dispatch-slot utilisation (0..1): pressure put on shared slots."""
        return self.x_full + self.fill * self.x_hw


@dataclasses.dataclass(frozen=True)
class AppProfile:
    name: str
    phases: Tuple[Phase, ...]
    omega: float
    retire: float
    mem_sens: float
    fetch_sens: float
    train: bool = True        # used to fit the Eq. 4 model (22 of 28)
    in_pool: bool = True      # member of the 24-app workload pool

    def phase(self, idx: int) -> Phase:
        return self.phases[idx % len(self.phases)]


def _phases(
    fe: float, be: float, hw: float, fill: float, n: int = 1, amp: float = 0.15,
    duration: int = 25,
) -> Tuple[Phase, ...]:
    """Build ``n`` phases around a base composition.

    Phase k scales (fe, be, hw) by deterministic factors in [1-amp, 1+amp]
    (different per component, alternating direction) and renormalises so the
    composition stays a valid distribution.  This gives each app mild,
    repeatable time-varying behaviour (real SPEC apps are phased).
    """
    out: List[Phase] = []
    for k in range(n):
        s = (-1.0) ** k
        f_fe = 1.0 + s * amp
        f_be = 1.0 - s * amp * 0.8
        f_hw = 1.0 + s * amp * 0.5 * ((-1.0) ** (k // 2))
        pfe, pbe, phw = fe * f_fe, be * f_be, hw * f_hw
        total = pfe + pbe + phw
        if total > 0.94:  # keep at least 6% full-dispatch cycles
            scale = 0.94 / total
            pfe, pbe, phw = pfe * scale, pbe * scale, phw * scale
        out.append(Phase(pfe, pbe, phw, fill, duration + 7 * k))
    return tuple(out)


def _app(name, fe, be, hw, fill, omega=0.1, retire=0.97, mem=0.5, fetch=0.5,
         n_phases=1, train=True, in_pool=True) -> AppProfile:
    return AppProfile(
        name=name,
        phases=_phases(fe, be, hw, fill, n=n_phases),
        omega=omega,
        retire=retire,
        mem_sens=mem,
        fetch_sens=fetch,
        train=train,
        in_pool=in_pool,
    )


# ---------------------------------------------------------------------------
# The 28 characterised applications (paper Figure 2).
# ---------------------------------------------------------------------------
APP_PROFILES: Tuple[AppProfile, ...] = (
    # ---- Frontend-heavy pool (measured FE > 0.35) --------------------------
    _app("perlbench_r", fe=0.42, be=0.16, hw=0.08, fill=0.50, omega=0.10,
         retire=0.90, mem=0.35, fetch=1.00, n_phases=2),
    _app("gcc_r",       fe=0.40, be=0.20, hw=0.06, fill=0.50, omega=0.45,
         retire=0.88, mem=0.45, fetch=0.95, n_phases=3),          # GT100 (+~6%)
    _app("xalancbmk_r", fe=0.45, be=0.22, hw=0.04, fill=0.50, omega=0.50,
         retire=0.91, mem=0.50, fetch=1.00),                      # GT100 (+~9%)
    _app("deepsjeng_r", fe=0.38, be=0.12, hw=0.10, fill=0.50, omega=0.80,
         retire=0.84, mem=0.25, fetch=0.85),                      # GT100 (+~5%)
    _app("gobmk",       fe=0.44, be=0.12, hw=0.08, fill=0.50, omega=0.15,
         retire=0.83, mem=0.25, fetch=0.90),
    _app("leela_r",     fe=0.37, be=0.12, hw=0.12, fill=0.50, omega=0.10,
         retire=0.85, mem=0.25, fetch=0.80, train=False),          # held out
    _app("exchange2_r", fe=0.36, be=0.04, hw=0.14, fill=0.60, omega=0.02,
         retire=0.93, mem=0.10, fetch=0.70, train=False),          # held out
    # ---- Backend-heavy pool (ISC3 BE incl. assigned gap > 0.65) ------------
    _app("mcf_r",       fe=0.18, be=0.72, hw=0.03, fill=0.40, omega=0.85,
         retire=0.90, mem=1.00, fetch=0.40, n_phases=2),          # GT100 (+~15%)
    _app("lbm_r",       fe=0.04, be=0.30, hw=0.55, fill=0.25, omega=0.02,
         retire=0.99, mem=0.55, fetch=0.05),                      # LT100 gap ~.41
    _app("cactuBSSN_r", fe=0.06, be=0.30, hw=0.52, fill=0.28, omega=0.02,
         retire=0.99, mem=0.45, fetch=0.10),                      # LT100 gap ~.37
    _app("milc",        fe=0.05, be=0.32, hw=0.52, fill=0.30, omega=0.02,
         retire=0.98, mem=0.55, fetch=0.05),                      # LT100 gap ~.36
    _app("bwaves_r",    fe=0.05, be=0.62, hw=0.22, fill=0.45, omega=0.05,
         retire=0.99, mem=0.85, fetch=0.05, n_phases=2),
    _app("fotonik3d_r", fe=0.04, be=0.68, hw=0.16, fill=0.40, omega=0.05,
         retire=0.99, mem=0.90, fetch=0.05),
    _app("roms_r",      fe=0.06, be=0.60, hw=0.20, fill=0.45, omega=0.05,
         retire=0.98, mem=0.70, fetch=0.10, n_phases=2),
    _app("libquantum",  fe=0.03, be=0.70, hw=0.08, fill=0.50, omega=0.10,
         retire=0.99, mem=1.00, fetch=0.05),
    # ---- Others pool --------------------------------------------------------
    _app("omnetpp_r",   fe=0.30, be=0.52, hw=0.04, fill=0.50, omega=0.40,
         retire=0.92, mem=0.80, fetch=0.70),                      # GT100 (+~10%)
    _app("soplex",      fe=0.12, be=0.58, hw=0.12, fill=0.45, omega=0.70,
         retire=0.94, mem=0.75, fetch=0.40),                      # GT100 (+~2%)
    _app("astar",       fe=0.22, be=0.48, hw=0.08, fill=0.50, omega=0.60,
         retire=0.88, mem=0.65, fetch=0.50),                      # GT100 (+~9%)
    _app("hmmer",       fe=0.05, be=0.18, hw=0.15, fill=0.70, omega=0.02,
         retire=0.97, mem=0.30, fetch=0.20, in_pool=False),
    _app("x264_r",      fe=0.15, be=0.25, hw=0.15, fill=0.60, omega=0.05,
         retire=0.95, mem=0.40, fetch=0.40, n_phases=2),
    _app("namd_r",      fe=0.04, be=0.22, hw=0.28, fill=0.50, omega=0.02,
         retire=0.99, mem=0.30, fetch=0.10, in_pool=False),
    _app("povray_r",    fe=0.18, be=0.12, hw=0.18, fill=0.55, omega=0.05,
         retire=0.94, mem=0.25, fetch=0.50, in_pool=False),
    _app("nab_r",       fe=0.08, be=0.35, hw=0.22, fill=0.50, omega=0.04,
         retire=0.98, mem=0.45, fetch=0.15, in_pool=False),
    _app("xz_r",        fe=0.12, be=0.45, hw=0.10, fill=0.50, omega=0.10,
         retire=0.93, mem=0.60, fetch=0.30, n_phases=2),
    _app("imagick_r",   fe=0.06, be=0.18, hw=0.25, fill=0.55, omega=0.03,
         retire=0.98, mem=0.30, fetch=0.15, train=False),          # held out
    _app("parest_r",    fe=0.08, be=0.42, hw=0.18, fill=0.50, omega=0.05,
         retire=0.98, mem=0.55, fetch=0.15, train=False),          # held out
    _app("wrf_r",       fe=0.10, be=0.38, hw=0.26, fill=0.45, omega=0.04,
         retire=0.97, mem=0.50, fetch=0.20, n_phases=3, train=False),  # held out
    _app("cam4_r",      fe=0.12, be=0.34, hw=0.24, fill=0.50, omega=0.04,
         retire=0.96, mem=0.45, fetch=0.25, n_phases=2, train=False),  # held out
)

assert len(APP_PROFILES) == 28
assert sum(1 for a in APP_PROFILES if not a.train) == 6
assert sum(1 for a in APP_PROFILES if a.in_pool) == 24


def train_profiles() -> List[AppProfile]:
    return [a for a in APP_PROFILES if a.train]


def pool_profiles() -> List[AppProfile]:
    return [a for a in APP_PROFILES if a.in_pool]
