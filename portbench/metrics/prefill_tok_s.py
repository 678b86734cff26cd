"""Prompt tokens of the window's whole prefill batches over its seconds."""


def read(run):
    w = run["window"]
    if "prefill_tokens" not in w:
        return None
    return w["prefill_tokens"] / w["seconds"]
