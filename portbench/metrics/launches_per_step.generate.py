"""Device kernels in the traced window over its decode steps."""


def read(run):
    t = run["trace"]
    if not t or "steps" not in t or not t["kernels"]:
        return None
    return t["kernels"] / t["steps"]
