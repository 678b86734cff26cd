"""The run-report layer of ``repro_torch.obs``, the twin of
``repro.obs.metrics``: one export format for a run's numbers, stamped
with the streams that made them.

A run export is the reference's schema::

    {
      "obs_schema_version": 2,
      "name": "...",                      # what was run
      "rng_stream_version": ...,          # stamps (version_stamp below)
      "scan_rng_stream_version": ...,
      "engine": "torch",
      "recorded_unix": ...,
      "metrics":   {flat name -> float},  # the comparable numbers
      "timelines": {name -> [per-quantum floats]},
      "telemetry": {arm -> TelemetryLog.to_dict()},
      "accuracy":  {arm -> accuracy_report()},
      "spans":     [chrome trace events],
      "meta":      {free-form context},
    }

The port's draws are not the reference's threefry streams
(``repro_torch.smt.scan_engine.TorchDraws``), so its exports carry the
port's own draw-stream version, :data:`repro_torch.smt.scan_engine.
TORCH_DRAW_STREAM_VERSION`, under ``scan_rng_stream_version``.  Loading
refuses an export whose stamps differ from the current code's, so a port
recording and a reference one are never compared silently: each
package's ``check_stamp`` refuses the other's draw stream.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

#: Version of the run-export schema (the reference's).  Loaders refuse
#: mismatches instead of migrating.
OBS_SCHEMA_VERSION = 2

#: Schemas :func:`load_run` accepts read-only: v1 exports carry no
#: ``accuracy`` block but are otherwise layout-compatible.
READABLE_SCHEMAS = (1, 2)

#: The engine every port export is stamped with.
ENGINE = "torch"


def version_stamp(faults: bool = False, batched: bool = False,
                  lanes: Optional[int] = None) -> Dict:
    """Stamp dict for a recorded result: the profiling campaign's stream
    version, ``engine="torch"`` and the port's draw-stream version; the
    fault-schedule stream version when ``faults`` is set; ``batched``
    (with ``lanes``, the lane count of the run) for results measured
    through a lane-batched run, whose per-scenario timings are a share of
    a whole-grid wall and so never compare silently with single runs."""
    from repro_torch.smt.scan_engine import TORCH_DRAW_STREAM_VERSION
    from repro_torch.smt.training import RNG_STREAM_VERSION

    stamp: Dict = {
        "rng_stream_version": RNG_STREAM_VERSION,
        "engine": ENGINE,
        "scan_rng_stream_version": TORCH_DRAW_STREAM_VERSION,
    }
    if faults:
        from repro_torch.online.faults import FAULT_RNG_STREAM_VERSION

        stamp["fault_rng_stream_version"] = FAULT_RNG_STREAM_VERSION
    if batched:
        stamp["batched"] = True
        if lanes is not None:
            stamp["lanes"] = int(lanes)
    return stamp


def check_stamp(obj: Dict, label: str = "run",
                batched: Optional[bool] = None,
                lanes: Optional[int] = None,
                write: bool = False) -> bool:
    """True when ``obj``'s stamps match the current code; says why not.

    An export of another engine, or one drawn from another stream (the
    reference's threefry draws among them), is refused.  ``batched`` and
    ``lanes``, when given, refuse a recording of the other measurement
    protocol or lane count; ``write`` demands the current schema exactly
    (a caller that will update or diff against the export)."""
    from repro_torch.smt.scan_engine import TORCH_DRAW_STREAM_VERSION
    from repro_torch.smt.training import RNG_STREAM_VERSION

    allowed = ((None, OBS_SCHEMA_VERSION) if write
               else (None,) + READABLE_SCHEMAS)
    if obj.get("obs_schema_version") not in allowed:
        what = (f"!= v{OBS_SCHEMA_VERSION} (write path)" if write
                else f"not readable (know {READABLE_SCHEMAS})")
        print(f"# refusing {label}: obs schema "
              f"v{obj.get('obs_schema_version')} {what}; re-record it")
        return False
    if obj.get("engine") != ENGINE:
        print(f"# refusing {label}: engine {obj.get('engine')!r} is not "
              f"{ENGINE!r}; re-record it with this package")
        return False
    if batched is not None and bool(obj.get("batched", False)) != batched:
        got = "batched" if obj.get("batched") else "single-lane"
        want = "batched" if batched else "single-lane"
        print(f"# refusing {label}: {got} recording, {want} expected "
              "(per-scenario timings are not comparable across the two "
              "measurement protocols); re-record it")
        return False
    if lanes is not None and obj.get("lanes") != lanes:
        print(f"# refusing {label}: lane count {obj.get('lanes')} != "
              f"{lanes}; re-record it")
        return False
    if obj.get("rng_stream_version") != RNG_STREAM_VERSION:
        print(f"# refusing {label}: rng stream "
              f"v{obj.get('rng_stream_version')} != v{RNG_STREAM_VERSION}; "
              "re-record it")
        return False
    if obj.get("scan_rng_stream_version") != TORCH_DRAW_STREAM_VERSION:
        print(f"# refusing {label}: draw stream "
              f"{obj.get('scan_rng_stream_version')!r} != "
              f"{TORCH_DRAW_STREAM_VERSION!r}; re-record it")
        return False
    if "fault_rng_stream_version" in obj:
        from repro_torch.online.faults import FAULT_RNG_STREAM_VERSION

        if obj["fault_rng_stream_version"] != FAULT_RNG_STREAM_VERSION:
            print(f"# refusing {label}: fault stream "
                  f"v{obj['fault_rng_stream_version']} != "
                  f"v{FAULT_RNG_STREAM_VERSION}; re-record it")
            return False
    return True


def export_run(
    name: str,
    metrics: Dict[str, float],
    timelines: Optional[Dict] = None,
    telemetry: Optional[Dict] = None,
    spans: Optional[List[Dict]] = None,
    meta: Optional[Dict] = None,
    faults: bool = False,
    batched: bool = False,
    lanes: Optional[int] = None,
    lane_metrics: Optional[Dict[str, Dict[str, float]]] = None,
    accuracy: Optional[Dict[str, Dict]] = None,
) -> Dict:
    """Build a run export (the schema in the module docstring).

    ``telemetry`` maps arm names to :class:`repro_torch.obs.telemetry.
    TelemetryLog` instances (or serialised dicts); ``timelines`` maps
    names to per-quantum sequences; ``lane_metrics`` carries cross-lane
    aggregates ``{metric: {"mean", "lo", "hi", "n"}}``; ``accuracy`` maps
    arm names to :func:`repro_torch.obs.accuracy.accuracy_report` dicts.
    Everything is coerced to JSON-native types.
    """
    run: Dict = {
        "obs_schema_version": OBS_SCHEMA_VERSION,
        "name": name,
        "recorded_unix": time.time(),
        **version_stamp(faults=faults, batched=batched, lanes=lanes),
        "metrics": {k: float(v) for k, v in metrics.items()},
    }
    if lane_metrics:
        run["lane_metrics"] = {
            k: {kk: (int(vv) if kk == "n" else float(vv))
                for kk, vv in v.items()}
            for k, v in lane_metrics.items()
        }
    if timelines:
        run["timelines"] = {
            k: [float(x) for x in v] for k, v in timelines.items()
        }
    if telemetry:
        run["telemetry"] = {
            k: (v.to_dict() if hasattr(v, "to_dict") else v)
            for k, v in telemetry.items()
        }
    if accuracy:
        run["accuracy"] = {k: dict(v) for k, v in accuracy.items()}
    if spans:
        run["spans"] = list(spans)
    if meta:
        run["meta"] = dict(meta)
    return run


def save_run(path: str, run: Dict) -> str:
    """Write a run export; write-then-rename so interrupts never leave a
    truncated file behind."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(run, f, indent=2)
    os.replace(tmp, path)
    return path


def load_run(path: str, write: bool = False) -> Optional[Dict]:
    """Load a run export; None when missing, unreadable or stale-stamped
    (see :func:`check_stamp`; ``write=True`` demands the current
    schema)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            obj = json.load(f)
    except Exception:
        print(f"# refusing unreadable run export {os.path.basename(path)}")
        return None
    if not isinstance(obj, dict) or "metrics" not in obj:
        print(f"# refusing {os.path.basename(path)}: not a run export "
              "(no 'metrics' block); re-record it")
        return None
    if not check_stamp(obj, label=os.path.basename(path), write=write):
        return None
    return obj


def stats_metrics(stats, prefix: str = "") -> Dict[str, float]:
    """Flatten an ``OnlineStats`` summary into export metric rows."""
    return {f"{prefix}{k}": float(v) for k, v in stats.summary().items()}


def throughput_metrics(res, prefix: str = "") -> Dict[str, float]:
    """Flatten a ``ThroughputResult`` into export metric rows (the port's
    race times policy and machine together, in
    ``machine_s_per_quantum``)."""
    return {
        f"{prefix}mean_true_slowdown": float(res.mean_true_slowdown),
        f"{prefix}ipc_geomean": float(res.ipc_geomean),
        f"{prefix}total_retired": float(res.total_retired),
        f"{prefix}machine_us_per_quantum": res.machine_s_per_quantum * 1e6,
    }
