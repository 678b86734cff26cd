"""``_mfu.share`` over the prefill window."""

from portbench.metrics._mfu import share


def read(run):
    return share(run, "prefill")
