"""The MoE layers' routing, dispatch and combine over a traced prefill
cycle: the device time of the kernels launched under the port's
``moe.route``, ``moe.dispatch`` and ``moe.combine`` spans, as a share of
the cycle's busy time.  Nothing off the card, or where the spans are
missing (a program without them)."""

PARTS = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    t = run["trace"]
    if not t or run["mix"]["entry"] != "prefill_spans" or not t["busy_s"]:
        return None
    spans = t.get("span_device_s", {})
    secs = sum(spans.get(p, 0.0) for p in PARTS)
    return 100.0 * secs / t["busy_s"] if secs else None
