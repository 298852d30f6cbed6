"""unspanned_s: the seconds of the traced run's profiled call that its
root span ("solve" or "solve_batched") holds and none of the root's
children covers (span_tree.py): what no program span names."""

from lpbench import span_tree


def read(run):
    t = span_tree.tree(run)
    return None if t is None else t["unspanned_s"]
