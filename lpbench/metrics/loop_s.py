"""loop_s: the mean over the window's calls of the iteration loop's seconds a call (Results.time, BatchedResults.solve_time)."""

from lpbench.readings import call_mean


def read(run):
    return call_mean(run, "loop_s")
