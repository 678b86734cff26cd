"""``_mfu.share`` over the generate window: every token a decode step
processed for a request (its prompt and its fed-back tokens)."""

from portbench.metrics._mfu import share


def read(run):
    return share(run, "generate")
