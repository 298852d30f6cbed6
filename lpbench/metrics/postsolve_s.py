"""postsolve_s: the mean over the window's calls of the span "postsolve"
(model.py::solve_with_presolve: the reduced solution mapped back to the
original space), a call's seconds on the host."""

from lpbench.readings import call_mean


def read(run):
    return call_mean(run, "postsolve_s")
