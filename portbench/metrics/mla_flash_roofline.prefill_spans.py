"""The flash kernel's share of its roofline under latent attention, over a
traced prefill cycle: the least time of every layer's MLA attention that
the cycle needs at its true head dims (``counts/mla_moe.py``: q and k of
Dn + Dr, v of Dv, causal, bfloat16) over the device time of the kernels
the profiler names ``flash_attention_kernel``, whatever they pad.
Nothing off the card, or where the kernel did not run once a layer of
every batch."""

from portbench.counts import mla_moe

KERNEL = "flash_attention_kernel"
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    t, cfg = run["trace"], run["cfg"]
    if not t or run["mix"]["entry"] != "prefill_spans":
        return None
    count = secs = 0.0
    for name, (n, s) in t["by_name"].items():
        if KERNEL in name:
            count += n
            secs += s
    if not secs or count != cfg["n_layers"] * len(t["batches"]):
        return None
    elem = ELEM_BYTES[cfg.get("dtype", "bfloat16")]
    least = sum(mla_moe.attention_least_seconds(cfg, b, s, elem)
                for b, s in t["batches"]) * cfg["n_layers"]
    return 100.0 * least / secs
