"""The flash kernel's share of its roofline over a traced prefill cycle:
the least time of every attention call the cycle needs
(``counts/attention.py``: windowed causal attention of each batch, one
call a layer, bfloat16) over the device time of the kernels the profiler
names ``flash_attention_kernel``.  Nothing where the kernel did not run
once a layer of every batch."""

from portbench.counts import attention

KERNEL = "flash_attention_kernel"
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    t, cfg = run["trace"], run["cfg"]
    if not t or "batches" not in t or run["mix"]["entry"] != "prefill":
        return None
    count = secs = 0.0
    for name, (n, s) in t["by_name"].items():
        if KERNEL in name:
            count += n
            secs += s
    if not secs or count != cfg["n_layers"] * len(t["batches"]):
        return None
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    least = sum(attention.least_seconds(
        b, s, cfg["n_heads"], cfg["n_kv_heads"], hd,
        cfg.get("sliding_window", 0), ELEM_BYTES[cfg.get("dtype", "bfloat16")])
        for b, s in t["batches"]) * cfg["n_layers"]
    return 100.0 * least / secs
