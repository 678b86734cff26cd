"""``_idle.share`` of a traced stretch of decode steps."""

from portbench.metrics._idle import share


def read(run):
    return share(run, "generate")
