"""The two cells of the QAP configuration and of float64 at 1e-8 on the CPU:
the catalog finds them with their metrics, the precision each runs on the
card, and tiny rehearsals through their entries (the MPS front door's from
a temporary configuration of its own) that print the contract's line with
the new span readings."""

import io
import json
import shutil
import sys

import pytest
import torch

from lpbench import catalog, run as harness

Q = "qap_nug30.mps_presolve_f32_1e-4"
F = "assign_orlib800.f64_1e-8"
CPU = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
# What each cell reads: the single-LP cells' readers, nug30's under
# `<name>.mps` moving peak_mem_gib (its rate spreads too widely on the
# host's clock to hold a bound, as setcover's), with the MPS front door's;
# the float64 cell's single-LP spans under `<name>.lps` where the name is
# the batched cell's.
SHARED = ["solve_p95_s", "ingest_s", "power_s", "capture_s", "loop_s",
          "iters", "halves_roofline", "device_idle", "finish_s",
          "unspanned_s"]
METRICS = {Q: {n + ".mps" for n in SHARED + ["lps_per_s", "autotune_s",
                                                 "ingest_host_s",
                                                 "ingest_layout_s"]}
           | {"read_s", "presolve_s", "postsolve_s", "validate_s"},
           F: set(SHARED) - {"finish_s", "unspanned_s"}
           | {n + ".lps" for n in ["autotune_s", "checks_s", "finish_s",
                                   "unspanned_s"]}
           | {"ingest_host_s", "ingest_layout_s"}}
REPORTED = {Q: {"peak_mem_gib", "setup_s"},
            F: {"lps_per_s", "peak_mem_gib", "setup_s"}}


@pytest.mark.parametrize("name", [Q, F])
def test_catalog_finds_the_cell_with_its_metrics(name):
    cell = catalog.find_cell(name)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == REPORTED[name]
    assert {m["name"] for m in cell.per_layer} == METRICS[name]
    moves = "peak_mem_gib" if name == Q else "lps_per_s"
    for m in cell.per_layer:
        assert m["moves"] == moves, m["name"]
        assert callable(catalog.reader(m["name"]))
    assert cell.limits["not_optimal"] == 0


def test_each_cell_runs_the_precision_it_states():
    from hprlp_tpu_torch import Parameters
    from hprlp_tpu_torch.solver.loop import resolve_dtype

    card = torch.device("cuda")
    want = {"f32": torch.float32, "f64": torch.float64}
    for name in (Q, F):
        traffic = catalog.find_cell(name).traffic
        params = Parameters(**traffic["parameters"])
        assert resolve_dtype(params, card) == want[traffic["dtype"]]
    assert Parameters(**catalog.find_cell(Q).traffic["parameters"]
                      ).use_presolve
    assert not Parameters(**catalog.find_cell(F).traffic["parameters"]
                          ).use_presolve


def _rehearse(cell, trace, seconds=0.3):
    out, sys_out = io.StringIO(), sys.stdout
    sys.stdout = out
    try:
        run = harness.execute(cell, 2**31 + 17, seconds, trace,
                              device="cpu", t_start=0.0)
        rc = harness.finish(run, dict(CPU))
    finally:
        sys.stdout = sys_out
    return rc, run, json.loads(out.getvalue().strip().splitlines()[-1])


def _tiny_qap(tmp_path):
    """The MPS cell on a QAP of size 4 (a 2 x 2 grid), from a temporary
    copy of the benchmark with a configuration of its own."""
    root, bench = tmp_path, tmp_path / "lpbench"
    shutil.copytree(catalog.HERE, bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(catalog.ROOT + "/BENCHMARK.json") as f:
        b = json.load(f)
    with open(catalog.HERE + "/configs/qap_nug30.json") as f:
        cfg = json.load(f)
    cfg.update(name="qap_tiny", n=4, grid=[2, 2], rows=104, cols=88,
               nnz=416)
    (bench / "configs" / "qap_tiny.json").write_text(json.dumps(cfg))
    b["configs"].append({"name": "qap_tiny", "source": cfg["source"],
                         "file": "lpbench/configs/qap_tiny.json",
                         "reduced": ["n"], "why": "a test"})
    cell = "qap_tiny.mps_presolve_f32_1e-4"
    b["workloads"].append({"name": cell, "config": "qap_tiny",
                           "traffic": "mps_presolve_f32_1e-4", "chips": 1,
                           "why": "a test"})
    for m in b["per_layer"]:
        if Q in m.get("workloads", []):
            m["workloads"].append(cell)
    shutil.copy(bench / "limits" / f"{Q}.json",
                bench / "limits" / f"{cell}.json")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    found = catalog.find_cell(cell, root=str(root), bench_dir=str(bench))
    m, n, nnz = found.generator.sizes(4)
    assert (m, n, nnz) == (104, 88, 416)
    # float32 on the CPU too, as on the card at 1e-4.
    found.traffic = {**found.traffic, "parameters": {
        **found.traffic["parameters"], "precision": "f32"}}
    return found


@pytest.mark.parametrize("trace", [False, True])
def test_mps_entry_runs_end_to_end_from_a_temporary_config(tmp_path, trace):
    cell = _tiny_qap(tmp_path)
    rc, run, line = _rehearse(cell, trace)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert run.shape == {"m": 104, "n": 88, "nnz": 416, "batch": 1}
    for rec in [run.warmup, *run.calls]:
        assert rec["rows_removed"] == rec["cols_removed"] == 0
        assert rec["nnz_removed"] == 0
    metrics = line["metrics"]
    if trace:
        for name in ["read_s", "presolve_s", "postsolve_s", "validate_s",
                     "lps_per_s.mps", "loop_s.mps", "iters.mps",
                     "finish_s.mps", "unspanned_s.mps"]:
            assert metrics[name]["value"] > 0, name
        assert not any(n.startswith("checks_s") for n in metrics)
    else:
        # No device on the CPU, so no peak memory: set-up alone.
        assert set(metrics) == {"setup_s"}


def test_f64_entry_runs_end_to_end_at_a_tiny_size():
    cell = catalog.find_cell(F)
    cell.config = {**cell.config, "n": 24, "rows": 48, "cols": 576,
                   "nnz": 1152}
    rc, run, line = _rehearse(cell, True)
    assert rc == 0 and line["correct"] is True
    # The autotune's choice is recorded a call.
    assert all(rec["backend"] for rec in [run.warmup, *run.calls])
    assert line["metrics"]["checks_s.lps"]["value"] > 0
    assert line["checks"]["kkt_worst"]["value"] <= 1e-8 * 1.01
