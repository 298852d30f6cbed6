"""iters: the mean over the window's calls of the iterations (batched: the slowest member's)."""

from lpbench.readings import call_mean


def read(run):
    return call_mean(run, "iters")
