"""The traced window: ``torch.profiler`` over part of a run, reduced to
the numbers the per-layer metrics and the result's ``breakdown`` read.

Device activities are summed from the raw trace
(``prof.profiler.kineto_results.events()``) without ``key_averages()``'s
tree of host events, whose building takes minutes on a trace of 100 k
launches: the arithmetic of ``chip_smoke.py``'s ``_device_events``,
copied.  Busy time is the union of the device activities' intervals;
an idle gap is a stretch between them, labelled by the host activity
that was running at its middle (the harness's own span, then the
innermost operation).
"""

from __future__ import annotations

import time

import numpy as np
import torch

#: Device activities that are not work: none is counted as busy (nor
#: the device-side copies of the harness's own spans).
_NOT_WORK = ("Sync",)
#: Entries of each list in the breakdown.
TOP = 10


class Window:
    """Opens and closes the profiler where a runner says (``start``,
    ``stop``), synchronising the device at both ends."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.seconds = None
        self._t0 = None

    def _sync(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def start(self):
        self._sync()
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.seconds = time.perf_counter() - self._t0
        self.prof.stop()


def _merge(intervals):
    """Sorted (start, end) pairs -> their union as disjoint pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(win: Window) -> dict:
    """busy_s, window_s, kernels (count), by_name {name: [count, s]},
    device_ops and idle_gaps (the breakdown's lists)."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in win.prof.profiler.kineto_results.events():
        row = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() != DeviceType.CUDA:
            cpu.append(row)
        elif not (e.is_user_annotation() or row[2].startswith("portbench.")
                  or any(w in row[2] for w in _NOT_WORK)):
            dev.append(row)
    by_name = {}
    kernels = 0
    for s, e, name in dev:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (e - s) / 1e9
        kernels += not name.startswith(("Memcpy", "Memset"))
    busy = _merge([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "busy_s": busy_s,
        "window_s": win.seconds,
        "kernels": kernels,
        "by_name": by_name,
        "device_ops": [[name[:160], secs] for name, (_n, secs) in ops],
        "idle_gaps": _idle_gaps(busy, cpu),
    }


def _idle_gaps(busy, cpu):
    if not busy or not cpu:
        return []
    lo = min(s for s, _, _ in cpu)
    hi = max(e for _, e, _ in cpu)
    edges = [lo] + [x for se in busy for x in se] + [hi]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    starts = np.array([s for s, _, _ in cpu], np.int64)
    ends = np.array([e for _, e, _ in cpu], np.int64)
    names = [n for _, _, n in cpu]
    out = []
    for length, s, e in gaps[:TOP]:
        mid = (s + e) // 2
        on = np.nonzero((starts <= mid) & (ends >= mid))[0]
        label = "host idle"
        if len(on):
            spans = [i for i in on if names[i].startswith("portbench.")]
            inner = on[np.argmin(ends[on] - starts[on])]
            outer = (names[max(spans, key=lambda i: ends[i] - starts[i])]
                     if spans else "")
            label = " > ".join(x for x in (outer, names[inner]) if x)
        out.append([label[:160], length / 1e9])
    return out
