"""Host span tracing — Chrome/Perfetto trace events for the run pipeline,
the twin of ``repro.obs.trace`` with the same event format.

A run's host-side story is a handful of coarse phases (presample ->
commit -> dispatch -> checkpoint -> stats).  :func:`span` wraps each phase
as a context manager; when tracing is enabled the spans are recorded as
Chrome trace-event ``"X"`` (complete) events — microsecond timestamps,
pid/tid — which :func:`save` writes as a JSON file loadable in
``chrome://tracing`` or https://ui.perfetto.dev.  Each span also opens a
``torch.profiler.record_function`` of the same name, so inside a
``torch.profiler`` capture the spans line up with the kernels they
launched.

Tracing is off by default and a disabled :func:`span` is a no-op context
manager (one truthiness check), so the engines keep their spans in place.
The recorder is process-global and append-only between :func:`enable` and
:func:`disable`; :func:`events` returns the raw list, :func:`to_chrome_trace`
the JSON-ready document.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

_enabled = False
_events: List[Dict] = []
_t0 = 0.0
_lock = threading.Lock()


def enable(clear: bool = True) -> None:
    """Start recording spans (optionally clearing previous events)."""
    global _enabled, _t0
    with _lock:
        if clear:
            _events.clear()
        _t0 = time.perf_counter()
        _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear() -> None:
    with _lock:
        _events.clear()


@contextlib.contextmanager
def span(name: str, **args):
    """One traced phase.  ``args`` become the event's ``args`` payload.

    Disabled tracing short-circuits before any clock read; enabled spans
    record a complete ("X") event inside a ``record_function`` of the
    same name, and nest by wall time.
    """
    if not _enabled:
        yield
        return
    t_start = time.perf_counter()
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            t_end = time.perf_counter()
            ev = {
                "name": name,
                "ph": "X",
                "ts": (t_start - _t0) * 1e6,
                "dur": (t_end - t_start) * 1e6,
                "pid": os.getpid(),
                "tid": threading.get_ident(),
            }
            if args:
                ev["args"] = {k: _jsonable(v) for k, v in args.items()}
            with _lock:
                _events.append(ev)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def events() -> List[Dict]:
    """The recorded events (shared list snapshot)."""
    with _lock:
        return list(_events)


def to_chrome_trace() -> Dict:
    """Chrome trace-event document: ``{"traceEvents": [...], ...}``."""
    return {
        "traceEvents": events(),
        "displayTimeUnit": "ms",
        "metadata": {"recorder": "repro_torch.obs.trace"},
    }


def save(path: str) -> str:
    """Write the trace JSON (open in chrome://tracing or Perfetto)."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(), f)
    return path


def instant(name: str, **args) -> None:
    """Record an instant ("i") event — a point-in-time marker with an
    args payload (a call's device cost)."""
    if not _enabled:
        return
    ev = {
        "name": name,
        "ph": "i",
        "s": "p",
        "ts": (time.perf_counter() - _t0) * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
    }
    if args:
        ev["args"] = {k: _jsonable(v) for k, v in args.items()}
    with _lock:
        _events.append(ev)


def dispatch_cost(name: str, fn, device) -> Optional[Dict]:
    """Attach one call's device cost to the trace.

    Runs ``fn()`` once more and records, as an instant event named
    ``<name>.cost``, on a CUDA ``device`` its device time (``device_ms``,
    CUDA events around the call) and the CUDA kernels ``torch.profiler``
    saw (``kernels``); on the CPU only the host's wall time
    (``host_ms``).  Returns the stat dict, or ``None`` when tracing is
    disabled or the profiler failed; never raises into the engine.
    """
    if not _enabled:
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    try:
        if not cuda:
            t0 = time.perf_counter()
            fn()
            stats = {"host_ms": (time.perf_counter() - t0) * 1e3}
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
            stats = {
                "device_ms": float(start.elapsed_time(end)),
                "kernels": int(sum(e.count for e in prof.key_averages()
                                   if e.device_type == DeviceType.CUDA)),
            }
    except Exception:
        return None
    instant(f"{name}.cost", **stats)
    return stats


def breakdown(evs: Optional[List[Dict]] = None) -> Dict[str, Dict]:
    """Aggregate events by span name: count, total/mean duration (us)."""
    evs = events() if evs is None else evs
    out: Dict[str, Dict] = {}
    for ev in evs:
        row = out.setdefault(
            ev["name"], {"count": 0, "total_us": 0.0}
        )
        row["count"] += 1
        row["total_us"] += float(ev.get("dur", 0.0))
    for row in out.values():
        row["mean_us"] = row["total_us"] / max(row["count"], 1)
    return out
