"""The traced window's share with no device activity, from the trace."""


def share(run, entry: str):
    t = run["trace"]
    if run["mix"]["entry"] != entry or not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
