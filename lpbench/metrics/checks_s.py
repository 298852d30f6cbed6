"""checks_s: the seconds of the span "checks" in the traced run's profiled call
(span_tree.py): the front door's conversion and checks of the inputs
(LpProblem.from_arrays; batched: the arrays' conversion, _normalize_inf, the
shape and bound checks)."""

from lpbench import span_tree


def read(run):
    return span_tree.seconds(run, "checks")
