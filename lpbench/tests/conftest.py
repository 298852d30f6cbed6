"""Cells cut to a size a CPU test holds: the same files, generators and
entries, tiny configurations, and the float32 the card runs at 1e-4."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

S = "setcover_rail4284.f32_1e-4"
A = "assign_orlib800.batch64_f32_1e-4"
TINY = {"setcover_rail4284": {"rows": 60, "cols": 3000, "nnz": 31000},
        "assign_orlib800": {"n": 24, "rows": 48, "cols": 576, "nnz": 1152}}


def tiny_cell(name: str, **parameters):
    """The cell `name` with a tiny configuration, batches of 4 members all
    judged, float32 as on the card, and `parameters` for the entry."""
    from lpbench import catalog

    cell = catalog.find_cell(name)
    cell.config = {**cell.config, **TINY[cell.config["name"]]}
    traffic = {**cell.traffic, "parameters": {
        **cell.traffic["parameters"], "precision": "f32", **parameters}}
    if traffic["batch"] > 1:
        traffic.update(batch=4, check=4)
    cell.traffic = traffic
    return cell
