"""The QAP LP relaxation of the benchmark's qap_nug30 configuration
(lpbench/generators/qap_nug30.py) and its MPS front door on the CPU: the
generator's sizes against the published qap15, nug20 and nug30; the
benchmark's own MPS writer read back identically by the native and the
Python reader; hprlp_tpu_torch.solve_mps with presolve on against HiGHS
and the benchmark's plain reference; and a file with one coefficient
altered judged not correct by the harness."""

import io
import json
import os
import sys

import numpy as np
import pytest
import scipy.optimize
import scipy.sparse as sp

import hprlp_tpu_torch as ht
from hprlp_tpu_torch.io import native_mps
from hprlp_tpu_torch.io.mps import read_mps
from lpbench import catalog, reference, run as harness
from lpbench.run import seeded

CELL = "qap_nug30.mps_presolve_f32_1e-4"
GEN = catalog.load_module(os.path.join(catalog.HERE, "generators",
                                       "qap_nug30.py"))
ENTRY = catalog.load_module(os.path.join(catalog.HERE, "entries",
                                         "solve_mps.py"))
# Published sizes (Mittelmann's LP test set): rows, columns, nonzeros.
PUBLISHED = {15: (6330, 22275, 94950), 20: (15240, 72600, 304800),
             30: (52260, 379350, 1567800)}
GRIDS = {4: [2, 2], 8: [2, 4], 15: [3, 5], 20: [4, 5], 30: [5, 6]}


def _cfg(N):
    with open(os.path.join(catalog.HERE, "configs", "qap_nug30.json")) as f:
        cfg = json.load(f)
    m, n, nnz = GEN.sizes(N)
    return {**cfg, "n": N, "grid": GRIDS[N], "rows": m, "cols": n,
            "nnz": nnz}


def _lp(N, seed=2**31 + 3):
    cfg = _cfg(N)
    gen = seeded(seed, "cpu")
    return GEN.matrix(cfg, gen), GEN.member(cfg, gen)


@pytest.mark.parametrize("N", [15, 20])
def test_generator_has_the_published_size(N):
    A, mb = _lp(N)
    assert A.shape[0] == PUBLISHED[N][0] and A.shape[1] == PUBLISHED[N][1]
    A.sum_duplicates()
    assert A.nnz == PUBLISHED[N][2]  # no entry twice
    assert GEN.sizes(N) == PUBLISHED[N]
    assert mb["c"].size == A.shape[1] and mb["AL"].size == A.shape[0]


def test_closed_form_gives_nug30_and_the_config_states_it():
    assert GEN.sizes(30) == PUBLISHED[30]
    with open(os.path.join(catalog.HERE, "configs", "qap_nug30.json")) as f:
        cfg = json.load(f)
    assert (cfg["rows"], cfg["cols"], cfg["nnz"]) == PUBLISHED[30]
    assert cfg["n"] == 30 and cfg["reduced"] == []


def test_rows_columns_and_costs_have_their_structure():
    N = 8
    A, mb = _lp(N)
    A = A.tocsr()
    nx = N * N
    # Every row has N entries; a y column 4, an x column 2N.
    assert np.all(np.diff(A.indptr) == N)
    per_col = np.diff(A.tocsc().indptr)
    assert np.all(per_col[:nx] == 2 * N) and np.all(per_col[nx:] == 4)
    # x: +1 in its two assignment rows, -1 in its 2(N - 1) link rows;
    # y: +1 in four link rows.
    C = A.tocsc()
    assert sorted(C[:, 0].data) == [-1.0] * (2 * N - 2) + [1.0, 1.0]
    assert np.all(C[:, nx:].data == 1.0)
    assert np.all(mb["c"][:nx] == 0.0) and np.all(mb["c"] >= 0.0)
    assert np.all(mb["c"] == np.round(mb["c"]))
    assert np.array_equal(mb["AL"], mb["AU"])
    assert mb["AL"][:2 * N].tolist() == [1.0] * (2 * N)
    assert not np.any(mb["AL"][2 * N:])
    # Same seed, same costs; another seed, other flows.
    assert np.array_equal(_lp(N)[1]["c"], mb["c"])
    assert not np.array_equal(_lp(N, seed=5)[1]["c"], mb["c"])


def test_writer_reads_back_identically_native_and_python(tmp_path):
    A, mb = _lp(8)
    path = str(tmp_path / "q8.mps")
    size = ENTRY.write_mps(path, A, mb["AL"], mb["AU"], mb["l"], mb["u"],
                           mb["c"])
    assert size == os.path.getsize(path) > 0
    assert native_mps.is_available()
    nat, py = native_mps.read_mps_native(path), read_mps(path)
    A = sp.csr_matrix(A)
    A.sort_indices()
    for p in (nat, py):
        B = p.A.tocsr()
        B.sort_indices()
        assert B.shape == A.shape
        assert np.array_equal(B.indptr, A.indptr)
        assert np.array_equal(B.indices, A.indices)
        assert np.array_equal(B.data, A.data)
        for key in ("AL", "AU", "l", "u", "c"):
            assert np.array_equal(getattr(p, key), mb[key]), key


def test_solve_mps_with_presolve_agrees_with_highs(tmp_path):
    A, mb = _lp(8)
    path = str(tmp_path / "q8.mps")
    ENTRY.write_mps(path, A, mb["AL"], mb["AU"], mb["l"], mb["u"], mb["c"])
    res = ht.solve_mps(path, ht.Parameters(verbose=False), device="cpu")
    assert res.status == "OPTIMAL"
    highs = scipy.optimize.linprog(mb["c"], A_eq=A, b_eq=mb["AL"],
                                   bounds=(0, None), method="highs")
    assert highs.status == 0
    assert abs(res.primal_obj - highs.fun) <= 1e-4 * abs(highs.fun)
    judged = reference.kkt(A, mb["AL"], mb["AU"], mb["l"], mb["u"],
                           mb["c"], res.x, res.y, res.z)
    assert judged["kkt"] < 1e-4


def _tiny_cell(N=4, **parameters):
    cell = catalog.find_cell(CELL)
    cell.config = _cfg(N)
    cell.traffic = {**cell.traffic, "parameters": {
        **cell.traffic["parameters"], "precision": "f32", **parameters}}
    return cell


def _rehearse(cell, seconds=0.3):
    """execute, judge and the result line on the CPU (finish() refuses
    where JAX is loaded, as in this test suite): the run and the line."""
    out, sys_out = io.StringIO(), sys.stdout
    sys.stdout = out
    try:
        run = harness.execute(cell, 2**31 + 13, seconds, False,
                              device="cpu", t_start=0.0)
        checks = harness.judge(run)
    finally:
        sys.stdout = sys_out
    return run, harness.result(run, checks, {"platform": "cpu"})


def test_presolve_removes_nothing_so_the_shape_is_the_loops():
    run, line = _rehearse(_tiny_cell())
    assert line["correct"] is True
    for rec in [run.warmup, *run.calls]:
        assert rec["status"] == ["OPTIMAL"]
        assert rec["rows_removed"] == rec["cols_removed"] == 0
        assert rec["nnz_removed"] == 0 and rec["rounds"] >= 1
        assert rec["read_s"] > 0 and rec["postsolve_s"] > 0
        assert rec["validate_s"] > 0 and rec["presolve_s"] > 0
    assert run.shape == dict(zip(("m", "n", "nnz"), GEN.sizes(4)),
                             batch=1)


def _alter_one_cost(real_make_pool):
    """make_pool, then one cost coefficient of each file raised by 1000."""
    def make_pool(*a, **k):
        pool = real_make_pool(*a, **k)
        for inst in pool:
            with open(inst["path"], "rb") as f:
                lines = f.read().split(b"\n")
            at = lines.index(b"COLUMNS") + 1
            while b" OBJ " not in lines[at]:
                at += 1
            name, row, value = lines[at].split()
            lines[at] = b" ".join([b"", name, row,
                                   str(float(value) + 1000.0).encode()])
            with open(inst["path"], "wb") as f:
                f.write(b"\n".join(lines))
        return pool
    return make_pool


def test_file_with_one_coefficient_altered_is_not_correct(monkeypatch):
    cell = _tiny_cell()
    monkeypatch.setattr(cell.entry, "make_pool",
                        _alter_one_cost(cell.entry.make_pool))
    run, line = _rehearse(cell)
    assert line["correct"] is False
    # The program solved what it read; the reference judged it against
    # the generator's LP.
    assert all(rec["status"] == ["OPTIMAL"] for rec in run.calls)
    checks = line["checks"]
    assert checks["kkt_worst"]["value"] > checks["kkt_worst"]["limit"]
