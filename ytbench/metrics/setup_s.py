"""Set-up: from the process's start to the window's opening (imports,
CUDA, the tables' generation, building and publishing their chunks, the
kernels' first builds, the warm-up that loads the cache)."""


def read(run):
    return run.setup_s
