"""95th percentile of the host-clock interval between successive decode
steps (``ServeEngine.serve_step`` starts) within each call of the
window."""

import numpy as np


def read(run):
    gaps = run["window"].get("step_intervals_s")
    if not gaps:
        return None
    return float(np.percentile(gaps, 95)) * 1e3
