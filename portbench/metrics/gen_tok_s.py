"""Tokens that the window's whole ``generate`` calls returned, over its
seconds."""


def read(run):
    w = run["window"]
    if "generated_tokens" not in w:
        return None
    return w["generated_tokens"] / w["seconds"]
