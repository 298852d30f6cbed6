"""ingest_vectors_s: the seconds of the span "ingest.vectors" in the traced
run's profiled call (span_tree.py): the batched ingest's per-member vectors:
the scatter into the padded layout, the host norms and scaling, the upload."""

from lpbench import span_tree


def read(run):
    return span_tree.seconds(run, "ingest.vectors")
