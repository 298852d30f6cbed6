"""power_s: the mean over the window's calls of the power method's seconds a call (Results/BatchedResults.power_time)."""

from lpbench.readings import call_mean


def read(run):
    return call_mean(run, "power_s")
