"""A later cell, configuration, traffic mix and metric are files and
entries: the harness finds them by name, here from a temporary directory,
and the benchmark's own file keeps to its contract's shape."""

import json
import os
import re
import shutil
import textwrap

import pytest

from lpbench import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_file_keeps_its_shape():
    with open(os.path.join(catalog.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["lpbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert callable(catalog.reader(m["name"]))
    for w in b["workloads"]:
        cell = catalog.find_cell(w["name"])
        assert cell.chips == 1
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        # Each per-layer metric moves an end-to-end metric its cell reports.
        assert all(m["moves"] in reported for m in cell.per_layer)
    for c in b["configs"]:
        assert c["file"].startswith("lpbench/configs/")
        assert len(c["source"]) <= 200
        with open(os.path.join(catalog.ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]


def test_added_cell_config_traffic_and_metric_are_found(tmp_path):
    """A new configuration with its generator, a new traffic mix, a new
    cell and a new per-layer metric, all in files of their own."""
    root, bench = tmp_path, tmp_path / "lpbench"
    shutil.copytree(catalog.HERE, bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(catalog.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    (bench / "configs" / "tiny_cover.json").write_text(json.dumps(
        {"name": "tiny_cover", "generator": "tiny_cover", "rows": 3,
         "cols": 4, "nnz": 6, "source": "a test", "reduced": []}))
    (bench / "generators" / "tiny_cover.py").write_text(textwrap.dedent("""
        import numpy as np
        import scipy.sparse as sp
        import torch

        def matrix(cfg, rng):
            return sp.csr_matrix(np.array([[1., 1, 0, 0], [0, 1, 1, 0],
                                           [0, 0, 1, 1.]]))

        def member(cfg, rng):
            return {"AL": np.ones(3), "AU": np.full(3, np.inf),
                    "l": np.zeros(4), "u": np.full(4, np.inf),
                    "c": torch.randint(1, 4, (4,), generator=rng).double()
                          .numpy()}
        """))
    (bench / "traffic" / "f64_1e-8.json").write_text(json.dumps(
        {"entry": "solve", "pool": 1, "batch": 1,
         "dtype": "f64",
         "parameters": {"stop_tol": 1e-8, "use_presolve": False,
                        "verbose": False}}))
    (bench / "limits" / "tiny_cover.f64_1e-8.json").write_text(json.dumps(
        {"kkt_worst": 1e-8, "not_optimal": 0}))
    (bench / "metrics" / "restarts.py").write_text(
        "def read(run):\n    return 7.0\n")
    b["configs"].append({"name": "tiny_cover", "source": "a test",
                         "file": "lpbench/configs/tiny_cover.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny_cover.f64_1e-8",
                           "config": "tiny_cover", "traffic": "f64_1e-8",
                           "chips": 1, "why": "a test"})
    # The new cell reports the rate, as a later PR would list it.
    next(m for m in b["end_to_end"] if m["name"] == "lps_per_s").get(
        "workloads", []).append("tiny_cover.f64_1e-8")
    b["per_layer"].append({"name": "restarts", "unit": "1",
                           "better": "lower", "source": "program_counter",
                           "layer": "loop", "moves": "lps_per_s",
                           "workloads": ["tiny_cover.f64_1e-8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = catalog.find_cell("tiny_cover.f64_1e-8", root=str(root),
                             bench_dir=str(bench))
    assert cell.config["rows"] == 3
    assert cell.traffic["parameters"]["stop_tol"] == 1e-8
    assert cell.limits["kkt_worst"] == 1e-8
    assert cell.generator.matrix(cell.config, None).nnz == 6
    assert hasattr(cell.entry, "call")
    assert [m["name"] for m in cell.per_layer] == ["restarts"]
    assert {m["name"] for m in cell.end_to_end} == {
        m["name"] for m in b["end_to_end"]}
    assert catalog.reader("restarts", bench_dir=str(bench))(None) == 7.0
    # A metric split by cell is read by its base's reader, unless it has
    # a file of its own.
    assert catalog.reader("restarts.tiny", bench_dir=str(bench))(
        None) == 7.0
    (bench / "metrics" / "restarts.own.py").write_text(
        "def read(run):\n    return 8.0\n")
    assert catalog.reader("restarts.own", bench_dir=str(bench))(
        None) == 8.0
    # The cells already there are found as before, with their metrics.
    old = catalog.find_cell("setcover_rail4284.f32_1e-4", root=str(root),
                            bench_dir=str(bench))
    assert "restarts" not in [m["name"] for m in old.per_layer]
    with pytest.raises(KeyError):
        catalog.find_cell("no_such.cell", root=str(root),
                          bench_dir=str(bench))
