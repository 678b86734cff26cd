"""Open-system cluster simulation: arrivals, queueing, departures.

``ClusterSim`` runs the SMT machine as an open queueing system: jobs arrive
(:mod:`repro_torch.online.arrivals`), wait in a FIFO queue while all 2N
hardware contexts are busy, get a free context, run to their §6.2
retired-instruction target under the policy's pairings, and depart.  Odd
active populations leave one application alone on its core (the
idle-context convention).

The port runs the device engine (``engine="scan"``,
:mod:`repro_torch.online.device_sim`) on the simulation's device.  A run is
a pure function of (pool, arrivals, policy, faults, seed, draws).
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.online.arrivals import ArrivalProcess
from repro_torch.online.faults import FaultProfile
from repro_torch.smt.apps import AppProfile
from repro_torch.smt.machine import PhaseTables, SMTMachine
from repro_torch.smt.metrics import OnlineStats


class ClusterSim:
    """One open-system run configuration.

    pool:      application profiles jobs are instances of;
    n_cores:   2-way SMT cores: capacity is ``2 * n_cores`` contexts;
    policy:    a :class:`repro_torch.smt.scan_engine.ScanPolicy` of kind
               ``"synpa"`` or ``"adjacent"``;
    arrivals:  an :class:`repro_torch.online.arrivals.ArrivalProcess`;
    target_scale: scales the §6.2 solo-reference instruction targets;
    admission: ``"fifo"`` (default) admits FIFO into the lowest free slot;
               ``"synergy"`` keeps the FIFO dequeue order but places each
               job by predicted pair score and seeds its ST estimate
               (:class:`repro_torch.online.admission.SynergyAdmission`,
               passed as ``synergy=``);
    engine:    ``"scan"``, the device engine; the reference's ``"host"``
               event loop is not ported (it needs the streaming allocator
               and the fault detectors of ``repro.ft``) and raises;
    faults:    optional :class:`repro_torch.online.faults.FaultProfile`
               (FIFO admission only, as in the reference);
    device:    where the run executes: ``cuda`` unless the caller passes
               ``device="cpu"``.  A synpa policy's model must live there.
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
        from repro_torch.online.device_sim import DEVICE_SIM_KINDS
        from repro_torch.smt.scan_engine import ScanPolicy

        if engine == "host":
            raise NotImplementedError(
                "the host event loop of ClusterSim is not ported yet "
                "(ROADMAP, open item 4: StreamingAllocator and repro.ft); "
                "use engine='scan'")
        if engine != "scan":
            raise ValueError(f"unknown engine {engine!r}")
        if n_cores < 1:
            raise ValueError(f"n_cores={n_cores}")
        if admission not in ("fifo", "synergy"):
            raise ValueError(f"unknown admission {admission!r}")
        if admission == "synergy" and synergy is None:
            raise ValueError("admission='synergy' needs a SynergyAdmission")
        if faults is not None and admission != "fifo":
            raise ValueError("fault injection requires admission='fifo'")
        if not (isinstance(policy, ScanPolicy)
                and policy.kind in DEVICE_SIM_KINDS):
            raise ValueError(f"engine='scan' needs a ScanPolicy of kind "
                             f"{DEVICE_SIM_KINDS}, got {policy!r}")
        self.device = resolve_device(device)
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

    def run(self, n_quanta: int, repeats: int = 1, warmup: bool = True,
            draws=None, telemetry: bool = False,
            app_telemetry: bool = False) -> OnlineStats:
        """Run ``n_quanta`` quanta; see
        :func:`repro_torch.online.device_sim.run_device_sim`.  A grid of
        such runs goes faster as one run:
        :func:`repro_torch.online.batch_sim.run_device_sim_batched`."""
        from repro_torch.online.device_sim import run_device_sim

        return run_device_sim(self, n_quanta, repeats=repeats, warmup=warmup,
                              draws=draws, telemetry=telemetry,
                              app_telemetry=app_telemetry)
