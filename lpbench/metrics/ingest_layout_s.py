"""ingest_layout_s: the seconds of the span "ingest.layout" in the traced run's
profiled call (span_tree.py): the single-LP ingest's layout stage: the gather
plan and the SpMV tiles of the scaled matrices, ended by a device sync."""

from lpbench import span_tree


def read(run):
    return span_tree.seconds(run, "ingest.layout")
