"""What the metric readers share: a span of the window's calls."""

from __future__ import annotations

import statistics


def call_mean(run, key: str):
    """The mean of the window's calls' `key`; None where a call lacks it."""
    values = [c.get(key) for c in run.calls]
    if not values or any(v is None for v in values):
        return None
    return statistics.fmean(values)
