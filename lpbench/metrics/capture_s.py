"""capture_s: the mean over the window's calls of the CUDA graph's warm-up and capture seconds a call (solve_problem.capture_time, solve_batched.capture_time)."""

from lpbench.readings import call_mean


def read(run):
    return call_mean(run, "capture_s")
