"""read_s: the mean over the window's calls of the span "read" (model.py
Model.from_mps: the MPS reader, native or Python, into the problem's CSR
arrays), a call's seconds on the host."""

from lpbench.readings import call_mean


def read(run):
    return call_mean(run, "read_s")
