"""autotune_s: the mean over the window's calls of the SpMV autotune's seconds a call (Results.autotune_time)."""

from lpbench.readings import call_mean


def read(run):
    return call_mean(run, "autotune_s")
