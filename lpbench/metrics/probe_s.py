"""probe_s: the seconds of the span "probe" in the traced run's profiled call
(span_tree.py): the batched dense probe (_probe_dense: the dense copies of A
and A^T and both candidates timed), on the card only."""

from lpbench import span_tree


def read(run):
    return span_tree.seconds(run, "probe")
