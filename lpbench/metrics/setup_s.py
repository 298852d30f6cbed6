"""setup_s: the process's start to the window's: imports, the pool made
from the seed, the warm-up call (and in a fresh checkout the kernels'
builds)."""


def read(run):
    return run.setup_s
