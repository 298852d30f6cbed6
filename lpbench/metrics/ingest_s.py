"""ingest_s: the mean over the window's calls of the ingest's seconds a call: Results.setup_time + scaling_time (layout, upload, scaling, tiles), or BatchedResults.setup_time."""

from lpbench.readings import call_mean


def read(run):
    return call_mean(run, "ingest_s")
