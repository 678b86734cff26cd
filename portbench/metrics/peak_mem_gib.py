"""``torch.cuda.max_memory_allocated()`` over the window (reset after
set-up), in GiB."""


def read(run):
    peak = run["window"].get("peak_bytes")
    return peak / 2 ** 30 if peak else None
