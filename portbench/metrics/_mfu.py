"""The whole step's share of the card's bfloat16 peak: the model FLOPs of
the window's work (``counts/model_step.py``, from the configuration's
shapes) over the window's seconds times the peak."""

from portbench.counts import h100


def share(run, entry: str):
    w = run["window"]
    if run["mix"]["entry"] != entry or not w.get("model_flops"):
        return None
    return 100.0 * w["model_flops"] / (w["seconds"] * h100.PEAK_BF16_FLOPS)
