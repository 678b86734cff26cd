"""Process start to the window's first call: imports, the weights' draw,
the kernels' load (and build, in a checkout's first run), the warm-up."""


def read(run):
    return run["setup_s"]
