"""The open-system layer: applications arrive, queue for a hardware
context, run to completion and depart, while SYNPA re-pairs every quantum.

* :class:`ClusterSim`        — a run configuration; ``engine="host"`` (the
                               default) runs the event loop on the host,
                               ``engine="scan"`` the whole horizon on the
                               device (:mod:`repro_torch.online.device_sim`);
* :class:`StreamingAllocator` — SYNPA for the host loop: the fused step on
                               the device, incremental re-matching on the
                               host; :class:`StreamingScheduler` is its
                               closed-system adapter;
* :class:`LinuxOnline` / :class:`RandomOnline` / :class:`AdjacentOnline`
                             — the online baselines;
* :class:`SynergyAdmission`  — profile-informed placement and ST hints;
* :class:`PoissonArrivals` / :class:`TraceArrivals` /
  :class:`InitialBatch`      — traffic models (:func:`presample`
                               materialises any of them);
* :class:`FaultProfile`      — seeded core failure/recovery and stragglers;
* :func:`run_device_sim_batched` — a scenario grid (seeds, loads,
                               admission rules, fault profiles) as one
                               lane-batched run
                               (:mod:`repro_torch.online.batch_sim`);
* :func:`run_device_sim_checkpointed` — a long run in segments, with a
                               snapshot at each segment's end and resume
                               after a kill.
"""

from repro_torch.online.admission import SynergyAdmission
from repro_torch.online.allocator import (
    IDLE_COST,
    AdjacentOnline,
    LinuxOnline,
    OnlinePolicy,
    RandomOnline,
    StreamingAllocator,
    StreamingConfig,
    StreamingScheduler,
    cold_config,
    exact_config,
)
from repro_torch.online.arrivals import (
    ArrivalProcess,
    InitialBatch,
    PoissonArrivals,
    TraceArrivals,
    presample,
)
from repro_torch.online.faults import (
    FAULT_RNG_STREAM_VERSION,
    FaultProfile,
    FaultSchedule,
)
from repro_torch.online.batch_sim import run_device_sim_batched
from repro_torch.online.device_sim import run_device_sim_checkpointed
from repro_torch.online.sim import ClusterSim

__all__ = [
    "AdjacentOnline",
    "ArrivalProcess",
    "ClusterSim",
    "FAULT_RNG_STREAM_VERSION",
    "FaultProfile",
    "FaultSchedule",
    "IDLE_COST",
    "InitialBatch",
    "LinuxOnline",
    "OnlinePolicy",
    "PoissonArrivals",
    "RandomOnline",
    "StreamingAllocator",
    "StreamingConfig",
    "StreamingScheduler",
    "SynergyAdmission",
    "TraceArrivals",
    "cold_config",
    "exact_config",
    "presample",
    "run_device_sim_batched",
    "run_device_sim_checkpointed",
]
