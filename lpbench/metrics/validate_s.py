"""validate_s: the mean over the window's calls of the span "validate"
(model.py::solve_with_presolve: the original-space float64 KKT error of
the postsolved point), a call's seconds on the host."""

from lpbench.readings import call_mean


def read(run):
    return call_mean(run, "validate_s")
