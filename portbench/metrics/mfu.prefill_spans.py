"""``_mfu.share`` over the window of the ``prefill_spans`` entry (model
FLOPs from ``counts/mla_moe.py``)."""

from portbench.metrics._mfu import share


def read(run):
    return share(run, "prefill_spans")
