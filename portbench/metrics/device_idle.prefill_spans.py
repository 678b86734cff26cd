"""``_idle.share`` of the traced cycle of the ``prefill_spans`` entry."""

from portbench.metrics._idle import share


def read(run):
    return share(run, "prefill_spans")
