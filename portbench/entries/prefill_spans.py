"""Closed-loop prefill of a model with latent attention and held experts,
read by the port's own spans.

The window is :mod:`entries.prefill`'s (whole cycles of the mix's
lengths through ``ServeEngine.prefill``, the greedy choice of every
position kept), with model FLOPs from :mod:`counts.mla_moe`.  The traced
cycle runs with the port's tracing on (``repro_torch.obs.trace``), so
that its spans open a ``record_function`` inside the profiler's window;
after the window closes, the device time of the kernels launched inside
each span (``span_device_s``), the held experts' pairs of every MoE call
(``held_pairs``, read from the device then) and the MLA and
grouped-expert calls are returned.
"""

from __future__ import annotations

import bisect

from portbench.counts import mla_moe
from portbench.entries import prefill

#: The port's spans whose kernels are timed.
SPANS = ("mla.prefill", "moe.route", "moe.dispatch", "moe.experts",
         "moe.combine")


class Runner(prefill.Runner):
    def window(self, seconds: float) -> dict:
        """:mod:`entries.prefill`'s window, whose FLOPs come from its
        module's ``model_step`` (no count for this family): counted by
        :mod:`counts.mla_moe` instead, after the timed loop."""
        counts, prefill.model_step = prefill.model_step, mla_moe
        try:
            return super().window(seconds)
        finally:
            prefill.model_step = counts

    def traced(self, win) -> dict:
        """One more cycle, of new data, inside the profiler's window, with
        the port's spans on."""
        from repro_torch.models import attention, moe
        from repro_torch.obs import trace as obs_trace

        cycle = self.traffic.cycle()
        moe.held_pairs()
        calls = (attention.MLA_PREFILL, moe.GROUPED_EXPERTS)
        obs_trace.enable()
        try:
            win.start()
            for tokens in cycle:
                self._one(tokens)
            win.stop()
        finally:
            obs_trace.disable()
        spans = obs_trace.events()
        obs_trace.clear()
        return {
            "batches": [list(t.shape) for t in cycle],
            "span_device_s": span_device_seconds(win.prof, spans, SPANS),
            "span_counts": {n: sum(1 for e in spans if e["name"] == n)
                            for n in SPANS},
            "held_pairs": moe.held_pairs(),
            "mla_prefill_calls": attention.MLA_PREFILL - calls[0],
            "grouped_expert_calls": moe.GROUPED_EXPERTS - calls[1],
        }


def span_device_seconds(prof, spans, names):
    """name -> device seconds of the kernels, copies and sets whose launch
    (the CUDA runtime call with the same correlation id) lies inside a
    span of that name; 0.0 where none did (the CPU)."""
    from torch.autograd import DeviceType

    bounds = {}
    for ev in spans:
        if ev.get("ph") == "X" and ev["name"] in names:
            start = int(ev["ts"] * 1e3)
            bounds.setdefault(ev["name"], []).append(
                (start, start + int(ev["dur"] * 1e3)))
    for iv in bounds.values():
        iv.sort()
    launched, device = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.correlation_id(), e.end_ns() - e.start_ns()))
        elif e.name().startswith("cu"):
            launched[e.correlation_id()] = e.start_ns()
    out = {n: 0.0 for n in names}
    for corr, dur in device:
        t = launched.get(corr)
        if t is None:
            continue
        for name, iv in bounds.items():
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                out[name] += dur / 1e9
    return out
