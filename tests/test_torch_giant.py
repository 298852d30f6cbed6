"""The giant regime: the port's ingest (solver/loop.py::build_ingest,
ops/device_problem.py::host_csr, upload_problem), which in the giant
regime keeps the tiles alone, and the presolve overlap (model.py), on the
CPU in f64.

The giant route is held bitwise to the port's standard route, and to the
JAX package's giant route and overlap at the tolerances below.  The JAX
package takes its giant route on the CPU only with
HPRLP_GIANT_LANE_FIRST_NNZ set and its constant lowered, as
tests/test_solver.py runs it (its lane kernel in interpret mode, its
scaling on the host); the port's constant is lowered with monkeypatch.
"""

import gc
import weakref

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu_torch as ht
import hprlp_tpu_torch.presolve as tps
from hprlp_tpu_torch import model as tmodel
from hprlp_tpu.model import Model as JaxModel
from hprlp_tpu.params import Parameters as JaxParameters
from hprlp_tpu.problem import LpProblem as JaxLpProblem
from hprlp_tpu.solver import autotune as jat
from hprlp_tpu.solver import loop as jloop
from hprlp_tpu_torch.ops import device_problem as tdp
from hprlp_tpu_torch.ops.tiles import build_tiles
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.solver import autotune as tat
from hprlp_tpu_torch.solver import loop as tloop

from conftest import random_lp as jax_random_lp

torch.set_num_threads(1)

GIANT = 50  # the lowered constant: every case below is "giant"
TOL = 1e-4


def _fixed_block():
    """tests/test_solver.py:644-657: random_lp(8, 128, 192, 0.08) with 96
    fixed columns that presolve removes (> 10% of nnz)."""
    base = jax_random_lp(8, m=128, n=192, density=0.08)
    n_fix = 96
    extra = sp.random(128, n_fix, density=0.3, random_state=3,
                      data_rvs=lambda k: np.random.default_rng(4).normal(
                          size=k)).tocsr()
    A2 = sp.hstack([base.A.tocsr(), extra]).tocsr()
    fixed = np.linspace(-1.0, 1.0, n_fix)
    shift = extra @ fixed
    return JaxLpProblem.from_arrays(
        A2, base.AL + shift, base.AU + shift, np.concatenate([base.l, fixed]),
        np.concatenate([base.u, fixed]),
        np.concatenate([base.c, np.ones(n_fix)]))


# tests/test_solver.py:565 (random31), :640 (random7, presolve removes
# nothing: the reuse branch), :644-657 (fixed_block: the discard branch).
CASES = {
    "random31": lambda: jax_random_lp(31, m=192, n=320, density=0.05),
    "random7": lambda: jax_random_lp(7, m=160, n=256, density=0.08),
    "fixed_block": _fixed_block,
}


def _problems(case):
    jp = CASES[case]()
    return jp, LpProblem.from_arrays(jp.A, jp.AL, jp.AU, jp.l, jp.u, jp.c)


@pytest.fixture
def giant(monkeypatch):
    """Both packages' giant routes on for problems of >= GIANT nnz."""
    monkeypatch.setenv("HPRLP_GIANT_LANE_FIRST_NNZ", str(GIANT))
    monkeypatch.setattr(jloop, "GIANT_LANE_FIRST_NNZ", GIANT)
    monkeypatch.setattr(tloop, "GIANT_LANE_FIRST_NNZ", GIANT)


@pytest.fixture
def ingests(monkeypatch):
    """Every ingest the port builds, in order, as (a weak reference to its
    lp's c, its seconds, whether it kept the tiles alone): the record
    keeps no tensor alive."""
    built = []
    build = tloop.build_ingest

    def recorded(*args, **kw):
        out = build(*args, **kw)
        built.append((weakref.ref(out[0].c), out[3], out[0].A.vals is None))
        return out

    monkeypatch.setattr(tloop, "build_ingest", recorded)
    return built


def _assert_same(a, b):
    assert a.status == b.status
    for k in ("iter", "primal_obj", "dual_obj", "gap", "residuals",
              "restarts", "iter4", "sigma_final", "spmv_backend"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("case", sorted(CASES))
def test_giant_route_is_standard_route_bitwise(case, monkeypatch, ingests):
    _, prob = _problems(case)
    p = ht.Parameters(verbose=False, stop_tol=TOL)
    monkeypatch.setattr(tloop, "GIANT_LANE_FIRST_NNZ", GIANT)
    r_giant = tloop.solve_problem(prob, p, device="cpu")
    monkeypatch.setattr(tloop, "GIANT_LANE_FIRST_NNZ", 10**18)
    r_std = tloop.solve_problem(prob, p, device="cpu")
    assert [alone for _, _, alone in ingests] == [True, False]
    assert r_giant.status == "OPTIMAL"
    _assert_same(r_giant, r_std)
    for res, (_, seconds, _) in zip((r_giant, r_std), ingests):
        assert set(seconds) == {"host", "upload", "scaling", "layout",
                                "wall"}
        assert res.scaling_time == seconds["scaling"]
        assert res.setup_time == seconds["wall"] - seconds["scaling"]


@pytest.mark.parametrize("case", ["random31", "random7"])
def test_giant_route_matches_jax_giant_route(case, giant):
    """The JAX package scales on the host and the port on the device, both
    in f64; their factors agree to ~1e-12 (tests/test_solver.py:452)."""
    jp, prob = _problems(case)
    rj = jloop.solve_problem(jp, JaxParameters(verbose=False, stop_tol=TOL))
    rt = tloop.solve_problem(prob, ht.Parameters(verbose=False, stop_tol=TOL),
                             device="cpu")
    assert rt.status == rj.status == "OPTIMAL"
    assert rt.iter == rj.iter
    assert rt.primal_obj == pytest.approx(rj.primal_obj, rel=1e-8)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case,reused", [("random7", True),
                                         ("fixed_block", False)])
def test_overlap_matches_jax_overlap(case, reused, giant, ingests,
                                     monkeypatch):
    """Model.solve with presolve on: presolve beside the ingest of the
    original.  random7: presolve removes < 10% of nnz and the original is
    solved on that one ingest.  fixed_block: it removes more, and the
    ingest is freed before the reduced problem is solved."""
    jp, prob = _problems(case)
    solved = []
    solve = tloop.solve_problem

    def recorded(problem, *args, _ingest=None, **kw):
        gc.collect()
        c = ingests[0][0]()
        solved.append((problem, _ingest is not None and _ingest[0].c is c,
                       c is None))
        del c
        return solve(problem, *args, _ingest=_ingest, **kw)

    monkeypatch.setattr(tmodel, "solve_problem", recorded)
    rt = ht.Model(prob).solve(ht.Parameters(verbose=False, stop_tol=TOL),
                              device="cpu")
    rj = JaxModel(jp).solve(JaxParameters(verbose=False, stop_tol=TOL))
    assert rt.status == rj.status == "OPTIMAL"
    assert rt.iter == rj.iter
    assert rt.primal_obj == pytest.approx(rj.primal_obj, rel=1e-8)
    assert rt.presolve_time > 0
    assert len(solved) == 1
    problem, passed, freed = solved[0]
    if reused:
        assert len(ingests) == 1
        assert problem is prob and passed and not freed
    else:
        assert problem is not prob and problem.nnz < 0.9 * prob.nnz
        assert not passed and freed
        # The reduced problem is giant too (GIANT nnz): its own ingest.
        assert len(ingests) == 2


def test_giant_ingest_keeps_only_the_tiles(monkeypatch):
    """After the giant ingest each matrix holds its tiles and nothing in
    CSR order: no indptr, indices or values, no perm, no row-block plan.
    The solve on it reads none of them (a read would raise)."""
    _, prob = _problems("random31")
    p = ht.Parameters(verbose=False, stop_tol=TOL)
    monkeypatch.setattr(tloop, "GIANT_LANE_FIRST_NNZ", GIANT)
    ingest = tloop.build_ingest(prob, p, "cpu")
    lp = ingest[0]
    for M, shape in ((lp.A, (lp.m, lp.n)), (lp.AT, (lp.n, lp.m))):
        assert M.indptr is None and M.indices is None and M.vals is None
        assert M.blocks is None and M.dense is None
        assert M.tiles is not None and M.tiles.perm is None
        assert (M.nrows, M.ncols) == shape
        assert M.nnz == prob.nnz
        assert M.dtype == torch.float64 and M.device.type == "cpu"
        with pytest.raises(ValueError, match="retile needs it"):
            M.tiles.retile(torch.zeros(M.nnz, dtype=M.dtype))
    res = tloop.solve_problem(prob, p, device="cpu", _ingest=ingest)
    assert res.status == "OPTIMAL" and res.spmv_backend == "tiled"


@pytest.mark.parametrize("backend,plan,tiles", [
    ("auto", True, True), ("lane", False, True), ("gather", True, False),
    ("dense", False, False)])
def test_standard_ingest_keeps_what_its_backends_read(backend, plan, tiles):
    """Below the giant regime the ingest keeps the CSR arrays, the
    "gather" plan where that backend may run and the tiles where they
    may, built from the scaled values: without perm, which nothing of a
    solve reads, and bitwise the tiles build_tiles makes of the scaled
    matrix."""
    _, prob = _problems("random31")
    p = ht.Parameters(verbose=False, stop_tol=TOL, spmv_backend=backend)
    lp = tloop.build_ingest(prob, p, "cpu")[0]
    for M in (lp.A, lp.AT):
        assert M.vals is not None and M.indices is not None
        assert (M.blocks is not None) == plan
        assert (M.tiles is not None) == tiles
        if tiles:
            T, ref = M.tiles, build_tiles(M)
            assert T.perm is None and T.nnz == M.nnz == prob.nnz
            for k in ("vals", "keys", "runs", "row_start"):
                assert torch.equal(getattr(T, k), getattr(ref, k)), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_default_layout_is_the_coo_layout_bitwise(case, dtype):
    """host_csr + upload_problem (the default layout, which the solve
    uploads) against build_device_problem's COO construction given the
    identity positions, on A with duplicate entries and explicit zeros:
    the same arrays, bit for bit."""
    _, prob = _problems(case)
    A = prob.A.tocoo()
    extra = np.arange(0, A.nnz, 7)
    A = sp.coo_matrix((np.concatenate([A.data, 0.5 * A.data[extra],
                                       np.zeros(3)]),
                       (np.concatenate([A.row, A.row[extra], [0, 1, 2]]),
                        np.concatenate([A.col, A.col[extra], [5, 6, 7]]))),
                      shape=A.shape)

    def copy():
        return LpProblem.from_arrays(A.copy(), prob.AL, prob.AU, prob.l,
                                     prob.u, prob.c)

    p = copy()
    got, maps = tdp.upload_problem(p, *tdp.host_csr(p), dtype=dtype)
    want, want_maps = tdp.build_device_problem(
        copy(), dtype=dtype, row_pos=np.arange(prob.m),
        col_pos=np.arange(prob.n))
    for M, W in ((got.A, want.A), (got.AT, want.AT)):
        assert (M.nrows, M.ncols) == (W.nrows, W.ncols)
        for k in ("indptr", "indices", "vals"):
            a, b = getattr(M, k), getattr(W, k)
            assert a.dtype == b.dtype and torch.equal(a, b), k
    for k in ("AL", "AU", "c", "l", "u"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    np.testing.assert_array_equal(maps.row_pos, want_maps.row_pos)
    np.testing.assert_array_equal(maps.col_pos, want_maps.col_pos)


def _refuse_tiles(monkeypatch):
    def refused(*args, **kw):
        raise RuntimeError("tiles refused")

    monkeypatch.setattr(tloop, "build_tiles", refused)


def test_ingest_failure_raises_from_solve_problem(monkeypatch, capsys):
    _, prob = _problems("random31")
    monkeypatch.setattr(tloop, "GIANT_LANE_FIRST_NNZ", GIANT)
    _refuse_tiles(monkeypatch)
    with pytest.raises(RuntimeError, match="tiles refused"):
        tloop.solve_problem(prob, ht.Parameters(verbose=False), device="cpu")
    assert "[presolve] failed" not in capsys.readouterr().err


def test_ingest_failure_raises_from_model_solve(monkeypatch, capsys):
    """The overlap's ingest fails: Model.solve raises it once presolve,
    which succeeded, has joined, and reports no presolve failure."""
    _, prob = _problems("random31")
    monkeypatch.setattr(tloop, "GIANT_LANE_FIRST_NNZ", GIANT)
    _refuse_tiles(monkeypatch)
    joined = []
    presolve = tps.presolve_problem

    def recorded(*args, **kw):
        out = presolve(*args, **kw)
        joined.append(out[0])
        return out

    monkeypatch.setattr(tps, "presolve_problem", recorded)
    with pytest.raises(RuntimeError, match="tiles refused"):
        ht.Model(prob).solve(ht.Parameters(verbose=False), device="cpu")
    assert joined == ["OK"]
    assert "[presolve] failed" not in capsys.readouterr().err


def test_presolve_failure_degrades_to_the_original(monkeypatch, capsys,
                                                   ingests):
    """A presolve that raises degrades to the original model, as it does
    outside the giant regime, on the ingest built beside it."""
    _, prob = _problems("random7")
    p = ht.Parameters(verbose=False, stop_tol=TOL)
    monkeypatch.setattr(tloop, "GIANT_LANE_FIRST_NNZ", GIANT)

    def failed(*args, **kw):
        raise RuntimeError("presolve refused")

    monkeypatch.setattr(tps, "presolve_problem", failed)
    res = ht.Model(prob).solve(p, device="cpu")
    assert "[presolve] failed (presolve refused)" in capsys.readouterr().err
    assert len(ingests) == 1
    _assert_same(res, tloop.solve_problem(prob, p, device="cpu"))


def test_mixed_builds_no_optimistic_ingest(monkeypatch, ingests):
    """precision="mixed" is outside the giant regime, so the overlap builds
    no ingest of the original (build_ingest refuses "mixed": an
    attempt would raise).  Each refinement stage solves in its own
    precision through solve_problem and takes the giant route itself, as
    the JAX package's stages do."""
    _, prob = _problems("random31")
    monkeypatch.setattr(tloop, "GIANT_LANE_FIRST_NNZ", GIANT)
    p = ht.Parameters(verbose=False, stop_tol=TOL, precision="mixed")
    assert not tloop.giant_regime(prob, p)
    with pytest.raises(ValueError, match="no single ingest"):
        tloop.build_ingest(prob, p, "cpu")
    res = ht.Model(prob).solve(p, device="cpu")
    assert res.status == "OPTIMAL"
    # The stages' ingests, each on the tiles alone.
    assert ingests and all(alone for _, _, alone in ingests)


@pytest.mark.parametrize("nnz_below,backend,precision,giant_route", [
    (False, "auto", "auto", True),
    (False, "lane", "f32", True),
    (False, "lane", "f64", True),
    (False, "gather", "auto", False),
    (False, "dense", "auto", False),
    (False, "auto", "mixed", False),
    (True, "auto", "auto", False),
])
def test_giant_regime(monkeypatch, nnz_below, backend, precision,
                      giant_route):
    _, prob = _problems("random31")
    monkeypatch.setattr(tloop, "GIANT_LANE_FIRST_NNZ",
                        prob.nnz + 1 if nnz_below else prob.nnz)
    p = ht.Parameters(spmv_backend=backend, precision=precision)
    assert tloop.giant_regime(prob, p) == giant_route


def test_giant_threshold_is_the_autotune_direct_threshold():
    assert (tloop.GIANT_LANE_FIRST_NNZ == tat.AUTOTUNE_LANE_DIRECT_NNZ
            == jat.AUTOTUNE_LANE_DIRECT_NNZ == 20_000_000)
