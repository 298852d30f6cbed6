"""What the span readers share: the span tree of a traced run's profiled
call, as the program recorded it (hprlp_tpu_torch/spans.py).

The program keeps the spans of a thread's last finished call
(`spans.last()`).  The metric readers run once the window has closed and
the answers are judged, after the profiled call, which no other call of
the program follows: so they read that call.  From it: the seconds of
each span name, summed over the call, and the part of the root's
interval that no child span covers (`unspanned_s`).  A run without a
profiled call, or a program without the recorder, gives nothing.
"""

from __future__ import annotations

ROOTS = ("solve", "solve_batched")


def tree(run) -> dict | None:
    """{"spans": {name: seconds summed}, "unspanned_s": seconds} of the
    run's profiled call, or None."""
    if not run.trace_on or not run.profiled:
        return None
    try:
        from hprlp_tpu_torch import spans
    except ImportError:
        return None
    records = spans.last()
    if not records or records[-1].name not in ROOTS:
        return None
    return summary(records)


def summary(records: list) -> dict:
    """{"spans": {name: seconds summed}, "unspanned_s": seconds} of one
    call's span records, its root last."""
    root = records[-1]
    totals = {}
    for s in records:
        totals[s.name] = totals.get(s.name, 0.0) + s.seconds
    children = sorted((s.start, s.end) for s in records
                      if s.parent == root.id)
    covered, reach = 0.0, root.start
    for s, e in children:
        s = max(s, reach)
        if e > s:
            covered += e - s
            reach = e
    return {"spans": totals, "unspanned_s": root.seconds - covered}


def seconds(run, name: str) -> float | None:
    """The seconds of the span `name` in the profiled call, summed; None
    where the call has no such span."""
    t = tree(run)
    return None if t is None else t["spans"].get(name)
