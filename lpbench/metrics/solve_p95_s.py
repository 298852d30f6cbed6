"""solve_p95_s: the 95th percentile (linear) of the window's call walls, each
on the host's clock around the entry."""

import numpy as np


def read(run):
    walls = [c["wall_s"] for c in run.calls]
    return float(np.percentile(walls, 95)) if walls else None
