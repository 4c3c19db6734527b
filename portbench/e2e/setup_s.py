"""setup_s: from the start of the process to the window's start (imports, the kernels'
build, the caches, the program's precompute and the warm-up)."""


def read(run):
    return run["setup_s"]
