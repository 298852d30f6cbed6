"""presolve_s: the mean over the window's calls of presolve's seconds a
call (Results.presolve_time: the span "presolve", model.py::_presolve),
on the host."""

from lpbench.readings import call_mean


def read(run):
    return call_mean(run, "presolve_s")
