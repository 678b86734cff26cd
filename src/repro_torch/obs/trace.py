"""Host span tracing — Chrome/Perfetto trace events for the run pipeline
and the serving path, in the event format of ``repro.obs.trace``.

A run's host-side story is a handful of coarse phases (presample ->
commit -> dispatch -> checkpoint -> stats; a serving call's decode steps
and their parts).  :func:`span` wraps each phase as a context manager;
when tracing is enabled the spans are recorded as Chrome trace-event
``"X"`` (complete) events — microsecond timestamps, pid/tid — which
:func:`save` writes as a JSON file loadable in ``chrome://tracing`` or
https://ui.perfetto.dev.  Inside a ``torch.profiler`` capture each span
also opens a ``torch.profiler.record_function`` of the same name, so the
spans line up with the kernels they launched.  :func:`record` writes a
span whose ends are known only afterwards (a request, stamped from the
steps that served it).

The clock is the profiler's: ``time.perf_counter_ns()`` plus one offset
to ``time.time_ns()`` taken at :func:`enable` (:func:`now_ns`), so the
stamps are monotonic and lie on the Unix base that the profiler's host
and device events carry; ``ts`` is in microseconds since the epoch.
Every span has an ``id`` and a ``parent``, the id of the span open
around it on the same thread when it began (``None`` at the top).

Because the clocks agree, :func:`idle_by_span` can split a profiled
window's device idle time by the span the host was in at the time.

Tracing is off by default and a disabled :func:`span` returns one shared
no-op context (one truthiness check), so the engines keep their spans in
place.  The recorder is process-global and append-only between
:func:`enable` and :func:`disable`; :func:`events` returns the raw list,
:func:`to_chrome_trace` the JSON-ready document.
"""

from __future__ import annotations

import bisect
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

_enabled = False
_events: List[Dict] = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()          # .stack: ids of the open spans
#: ``time.time_ns()`` less ``time.perf_counter_ns()``, taken again at
#: each :func:`enable`.
_offset_ns = time.time_ns() - time.perf_counter_ns()


def now_ns() -> int:
    """The trace's clock: Unix nanoseconds, read off the monotonic
    ``perf_counter_ns``."""
    return time.perf_counter_ns() + _offset_ns


def enable(clear: bool = True) -> None:
    """Start recording spans (optionally clearing previous events)."""
    global _enabled, _offset_ns
    with _lock:
        if clear:
            _events.clear()
        _offset_ns = time.time_ns() - time.perf_counter_ns()
        _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear() -> None:
    with _lock:
        _events.clear()


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _append(name, start_ns, end_ns, sid, parent, args) -> None:
    ev = {
        "name": name,
        "ph": "X",
        "ts": start_ns / 1e3,
        "dur": (end_ns - start_ns) / 1e3,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "id": sid,
        "parent": parent,
    }
    if args:
        ev["args"] = {k: _jsonable(v) for k, v in args.items()}
    with _lock:
        _events.append(ev)


class _Noop:
    """What a disabled :func:`span` returns: records nothing."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "args", "id", "parent", "_start", "_range")

    def __init__(self, name: str, args: Dict):
        self.name, self.args = name, args
        self.id = next(_ids)
        self.parent = None

    def set(self, **args) -> None:
        """Add to the event's ``args`` before the span closes."""
        self.args.update(args)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
        self._start = now_ns()
        if self._range is not None:
            self._range.__enter__()
        stack.append(self.id)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        end = now_ns()
        _append(self.name, self._start, end, self.id, self.parent, self.args)
        return False


def span(name: str, **args):
    """One traced phase.  ``args`` become the event's ``args`` payload;
    the context's ``set(**more)`` adds to them before it closes.

    Disabled tracing returns the shared no-op context before any clock
    read; an enabled span reads the clock, opens a ``record_function`` of
    the same name while a ``torch.profiler`` capture is running (it costs
    about 30 us a span on the host otherwise), and on exit closes it and
    reads the clock again, so its interval encloses the profiler's.
    """
    if not _enabled:
        return _NOOP
    return _Span(name, args)


def record(name: str, start_ns: int, end_ns: int, **args) -> Optional[int]:
    """Write a span whose ends (:func:`now_ns` stamps) are known only
    afterwards; its parent is the span open on this thread now.  Returns
    its id, or ``None`` when tracing is disabled."""
    if not _enabled:
        return None
    stack = _stack()
    sid = next(_ids)
    _append(name, start_ns, end_ns, sid, stack[-1] if stack else None, args)
    return sid


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
        "ts": now_ns() / 1e3,
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


def _stack_spans(evs: List[Dict]) -> List[tuple]:
    """(start_ns, end_ns, name) of the complete events that lie on the
    host's call stack: within their parent wherever the parent is among
    ``evs``.  A span written by :func:`record` across its parent's bounds
    (a request, from its call's start to its last token) is left out."""
    iv = {}
    for ev in evs:
        if ev.get("ph") == "X" and "id" in ev:
            start = ev["ts"] * 1e3
            iv[ev["id"]] = (start, start + ev["dur"] * 1e3, ev["name"],
                            ev.get("parent"))
    out = []
    for s, e, name, parent in iv.values():
        up = iv.get(parent)
        if up is None or (up[0] <= s and e <= up[1]):
            out.append((s, e, name))
    return out


def idle_by_span(evs: List[Dict], busy, t0_ns: int, t1_ns: int) -> Dict:
    """Seconds of the window [``t0_ns``, ``t1_ns``] outside the sorted,
    disjoint ``busy`` (start_ns, end_ns) intervals of device work, by the
    span of ``evs`` innermost on the host's stack at the time
    (:func:`_stack_spans`; the open span that started last), under
    ``"none"`` where no span was open.  Every span name there has an
    entry, 0.0 where the device never idled under it; the values sum to
    the window's idle time."""
    idle, cur = [], t0_ns
    for s, e in busy:
        if s >= t1_ns:
            break
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if cur < t1_ns:
        idle.append((cur, t1_ns))
    iv = _stack_spans(evs)
    out = {name: 0.0 for _, _, name in iv}
    out["none"] = 0.0
    # Starts sort before ends at one instant: a span of no length opens
    # and closes before the stretch that follows it.
    marks = sorted([(s, 0, i) for i, (s, _, _) in enumerate(iv)] +
                   [(e, 1, i) for i, (_, e, _) in enumerate(iv)])
    times = [t for t, _, _ in marks]
    pos, open_ = 0, set()
    for a, b in idle:
        cuts = [a] + times[bisect.bisect_right(times, a):
                           bisect.bisect_left(times, b)] + [b]
        for lo, hi in zip(cuts, cuts[1:]):
            while pos < len(marks) and marks[pos][0] <= lo:
                _, end, i = marks[pos]
                (open_.discard if end else open_.add)(i)
                pos += 1
            name = "none"
            if open_:
                name = iv[max(open_, key=lambda i: (iv[i][0], -iv[i][1]))][2]
            out[name] += (hi - lo) / 1e9
    return out
