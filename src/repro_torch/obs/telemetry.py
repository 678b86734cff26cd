"""Device telemetry rings — the per-quantum counter layer of
``repro_torch.obs``, the twin of ``repro.obs.telemetry``.

The device engines (``repro_torch.smt.scan_engine``, the closed race;
``repro_torch.online.device_sim``, the open system) optionally record one
fixed-shape float32 vector per quantum on the device, stacked into a
``(Q, F)`` ring and fetched once after the run, with the results.  The
ring only reads the loop's tensors and never feeds the carry, so a run
with the ring on is bit-identical to one without it, and the ring adds no
host sync inside the quantum loop.

The field catalogues below are the schema (the reference's, name for name):
the engines build their vectors in this order, and :class:`TelemetryLog`
names the columns back on the host.  Counters that do not apply to a
quantum (policy fields on quantum 0, GN fields under a non-SYNPA policy)
are recorded as zero.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

#: Per-pair-solve diagnostics of the fused SYNPA step
#: (``repro_torch.core.synpa.make_fused_step(..., with_diag=True)``),
#: reduced over the quantum's valid solves.
FUSED_DIAG_FIELDS = (
    "gn_iters_mean",      # mean LM steps over the quantum's pair solves
    "gn_iters_max",       # worst row's LM step count
    "gn_residual_max",    # worst row's final inverse residual
    "gn_fallbacks",       # rows the heavy-ball fallback won
)

#: Closed-race ring (``repro_torch.smt.scan_engine``), one vector per quantum.
CLOSED_FIELDS = (
    "real_slowdown_mean",  # ground-truth mean slowdown of the pairing
    "real_slowdown_max",   # worst slot's ground-truth slowdown
    "pred_cost_mean",      # mean predicted pair slowdown (cost/2) matched
    "two_opt_rounds",      # device-matcher parallel swap rounds
) + FUSED_DIAG_FIELDS

#: Fault counters of the open-system ring.  Like ``departures`` they are
#: filled on the host after the fetch (failures, recoveries and straggling
#: are fault-schedule data; evictions and requeues are the run's integer
#: counts): the device vector carries zeros in these columns.
FAULT_FIELDS = (
    "failures",            # cores newly down this quantum
    "recoveries",          # cores newly back up this quantum
    "evictions",           # jobs evicted off failed cores this quantum
    "requeues",            # evicted jobs re-admitted this quantum
    "straggling",          # up cores running degraded (speed < 1)
)

#: Open-system ring (``repro_torch.online.device_sim``), one vector per
#: quantum.
OPEN_FIELDS = (
    "queue_head",          # jobs admitted so far (queue head index)
    "queue_tail",          # jobs arrived so far (queue tail index)
    "queue_depth",         # tail - head: jobs waiting for a context
    "admissions",          # jobs admitted this quantum
    "departures",          # jobs departed this quantum
    "active",              # contexts holding a job
    "solo",                # active contexts running alone
    "real_slowdown_mean",  # mean ground-truth slowdown of active contexts
    "real_slowdown_max",   # worst active context's ground-truth slowdown
    "pred_cost_mean",      # mean predicted pair slowdown of the matching
    "repair_dirty",        # churn-repair dirty vertices re-paired
    "two_opt_rounds",      # device-matcher parallel swap rounds
) + FUSED_DIAG_FIELDS + FAULT_FIELDS


#: Per-application ring (``app_telemetry=True`` on either engine), one
#: ``(S, F)`` block per quantum where ``S`` is the machine's context count
#: (closed race: the N hardware contexts; open system: the capacity).
APP_FIELDS = (
    "app_id",           # occupant app id (closed: slot index; -1 = empty)
    "partner_app_id",   # co-runner's app id, -1 when solo/empty
    "pred_cost",        # predicted per-app slowdown (Eq.4 pair cost / 2)
    "real_slowdown",    # ground-truth slowdown this quantum (0 = empty)
    "residual",         # pred_cost - real_slowdown where both exist
    "st_c1",            # ST-estimated performance-stack share, category 1
    "st_c2",            # ... category 2
    "st_c3",            # ... category 3
    "st_c4",            # ... category 4 (zero under 3-category models)
)

#: Width of the ST stack slice in :data:`APP_FIELDS`: models with fewer
#: categories are zero-padded so the ring shape is model-independent.
APP_ST_WIDTH = 4


class TelemetryLog:
    """Host-side view of a fetched ``(Q, F)`` telemetry ring.

    ``fields`` names the columns (one of the catalogues above); ``data``
    is the fetched ring as float64.
    """

    def __init__(self, fields: Sequence[str], data, policy: str = ""):
        self.fields = tuple(fields)
        self.data = np.asarray(data, np.float64)
        self.policy = policy
        assert self.data.ndim == 2 and self.data.shape[1] == len(
            self.fields
        ), (self.data.shape, len(self.fields))

    @property
    def quanta(self) -> int:
        return self.data.shape[0]

    def timeline(self, name: str) -> np.ndarray:
        """The (Q,) per-quantum series of one counter."""
        return self.data[:, self.fields.index(name)]

    def summary(self) -> Dict[str, float]:
        """Flat per-counter mean/max dict — the run-report metrics rows."""
        out: Dict[str, float] = {}
        for k, name in enumerate(self.fields):
            col = self.data[:, k]
            out[f"tlm_{name}_mean"] = float(col.mean()) if col.size else 0.0
            out[f"tlm_{name}_max"] = float(col.max()) if col.size else 0.0
        return out

    def to_dict(self) -> Dict:
        """JSON-ready payload (the ``telemetry`` block of a run export)."""
        return {
            "policy": self.policy,
            "fields": list(self.fields),
            "data": [[float(v) for v in row] for row in self.data],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "TelemetryLog":
        return cls(d["fields"], np.asarray(d["data"], np.float64),
                   policy=d.get("policy", ""))

    def __repr__(self) -> str:
        return (f"TelemetryLog(policy={self.policy!r}, "
                f"quanta={self.quanta}, fields={len(self.fields)})")


class AppTelemetryLog:
    """Host-side view of a fetched ``(Q, S, F)`` per-application ring.

    ``Q`` quanta, ``S`` contexts/slots, ``F == len(fields)`` counters per
    occupant (:data:`APP_FIELDS`).  A slot with ``app_id < 0`` held no job
    that quantum; its other columns are zero and excluded by
    :meth:`valid`.  The aggregation lives in :mod:`repro_torch.obs.accuracy`.
    """

    def __init__(self, fields: Sequence[str], data, policy: str = ""):
        self.fields = tuple(fields)
        self.data = np.asarray(data, np.float64)
        self.policy = policy
        assert self.data.ndim == 3 and self.data.shape[2] == len(
            self.fields
        ), (self.data.shape, len(self.fields))

    @property
    def quanta(self) -> int:
        return self.data.shape[0]

    @property
    def slots(self) -> int:
        return self.data.shape[1]

    def series(self, name: str) -> np.ndarray:
        """The (Q, S) per-quantum, per-slot series of one counter."""
        return self.data[:, :, self.fields.index(name)]

    def valid(self) -> np.ndarray:
        """(Q, S) bool mask: the slot held a job that quantum."""
        return self.series("app_id") >= 0

    def to_dict(self) -> Dict:
        """JSON-ready payload (the ``app_telemetry`` block of an export)."""
        return {
            "policy": self.policy,
            "fields": list(self.fields),
            "data": [[[float(v) for v in slot] for slot in row]
                     for row in self.data],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "AppTelemetryLog":
        return cls(d["fields"], np.asarray(d["data"], np.float64),
                   policy=d.get("policy", ""))

    def __repr__(self) -> str:
        return (f"AppTelemetryLog(policy={self.policy!r}, "
                f"quanta={self.quanta}, slots={self.slots}, "
                f"fields={len(self.fields)})")
