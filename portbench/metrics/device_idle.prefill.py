"""``_idle.share`` of a traced prefill cycle."""

from portbench.metrics._idle import share


def read(run):
    return share(run, "prefill")
