"""The held experts' share of their roofline over a traced prefill cycle:
the least time of each MoE call's grouped products for the pairs that
landed on the held experts (``counts/mla_moe.py``: three products of
d x moe_d_ff a pair, or the held weights read once) over the device time
of the kernels launched under the port's ``moe.experts`` span.  Nothing
off the card, or where the spans or the counts are missing (a program
without them)."""

from portbench.counts import mla_moe

ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    t, cfg = run["trace"], run["cfg"]
    if not t or run["mix"]["entry"] != "prefill_spans":
        return None
    secs = t.get("span_device_s", {}).get("moe.experts")
    pairs = t.get("held_pairs")
    if not secs or not pairs:
        return None
    elem = ELEM_BYTES[cfg.get("dtype", "bfloat16")]
    least = sum(mla_moe.experts_least_seconds(cfg, n, elem) for n in pairs)
    return 100.0 * least / secs
