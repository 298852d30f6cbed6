"""The port's mesh solves on 2 gloo ranks against the JAX package's mesh
solves (tests/test_parallel.py's cases, on the 8 virtual CPU devices of
tests/conftest.py), and every rank's Results against the others'.

One launch of 2 ranks (parallel/distributed.py::launch, the ranks running
test_torch_parallel_ranks.py::run_cases) runs every multi-rank case and
returns each rank's results; the JAX references are computed meanwhile.
"""

import threading

import numpy as np
import pytest
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu.params import Parameters as JaxParameters
from hprlp_tpu.solver import loop as jloop
from hprlp_tpu.solver.batched import solve_batched as jax_solve_batched
from hprlp_tpu.solver.loop import solve_problem as jax_solve
from hprlp_tpu_torch.parallel import distributed
from hprlp_tpu_torch.problem import LpProblem

import test_torch_parallel_ranks as ranks
from conftest import random_lp as jax_random_lp
from test_torch_parallel_ranks import batched_args, same_results

torch.set_num_threads(1)

WORLD = 2
JAX_DEVICES = 8  # tests/test_parallel.py's NDEV


def _port(jp) -> LpProblem:
    return LpProblem.from_arrays(jp.A, jp.AL, jp.AU, jp.l, jp.u, jp.c)


def _quiet(cls, **kw):
    return cls(verbose=False, use_presolve=False, **kw)


# tests/test_parallel.py's cases: :28 (f64, 1e-6), :124 (f32 lane, 1e-5),
# :204 (giant, 1e-4), :66 (batched, B=16).
LP21 = {"seed": 21, "m": 60, "n": 80, "density": 0.2}
LP32 = {"seed": 32, "m": 60, "n": 80, "density": 0.2}
LP42 = {"seed": 42, "m": 96, "n": 128, "density": 0.1}
KW_F64 = {"stop_tol": 1e-6}
KW_LANE = {"stop_tol": 1e-5, "precision": "f32", "spmv_backend": "lane"}
KW_GIANT = {"stop_tol": 1e-4}
B = 16
# tests/test_torch_refine.py's refinement case (test_refined_matches_f64),
# with f64 stages, on which the port's one-card "mixed" takes the JAX
# package's iterations (tests/test_torch_refine.py); the f32 stages' mesh
# route is held bitwise to the one-card route at one rank
# (test_torch_parallel_ranks.py), since 2 gloo ranks take minutes for
# their ~10^5 iterations.
LP_MIXED = {"seed": 42, "m": 30, "n": 45, "density": 0.3}
KW_MIXED = {"stop_tol": 1e-8, "precision": "mixed",
            "refine_stage_precision": "f64"}
# tests/test_torch_giant.py's overlap cases: random7 (presolve removes
# nothing: the ingest is reused) and fixed_block (presolve removes more
# than REINGEST_SHARE: the ingest is discarded).
LP7 = {"seed": 7, "m": 160, "n": 256, "density": 0.08}
# Model.solve with no mesh inside the group: each rank its own LP.
KW_OWN = {"stop_tol": 1e-6, "verbose": True}


def _fixed_block():
    from test_torch_giant import _fixed_block as fixed_block

    return fixed_block()


def _lp(spec):
    spec = dict(spec)
    return jax_random_lp(spec.pop("seed"), **spec)


def _cases():
    mesh = {"mesh_shape": WORLD}
    return [
        ("facts", "facts", (), {}),
        ("f64", "solve", (_port(_lp(LP21)),
                          _quiet(ht.Parameters, **KW_F64, **mesh)), {}),
        ("lane", "solve", (_port(_lp(LP32)),
                           _quiet(ht.Parameters, **KW_LANE, **mesh)), {}),
        ("giant", "giant", (_port(_lp(LP42)),
                            _quiet(ht.Parameters, **KW_GIANT, **mesh)), {}),
        ("batched", "batched", batched_args(B),
         {"params": ht.Parameters(verbose=False, **mesh)}),
        ("model", "model", (_port(_lp(LP21)), ht.Parameters(
            verbose=False, stop_tol=1e-6, **mesh)), {}),
        ("mixed", "solve", (_port(_lp(LP_MIXED)),
                            _quiet(ht.Parameters, **KW_MIXED, **mesh)), {}),
        ("presolve_once", "presolve_once", (_port(_fixed_block()),
                                            ht.Parameters(verbose=False,
                                                          **KW_GIANT,
                                                          **mesh)), {}),
        ("overlap_reuse", "giant_model", (_port(_lp(LP7)), ht.Parameters(
            verbose=False, **KW_GIANT, **mesh)), {}),
        ("overlap_discard", "giant_model", (_port(_fixed_block()),
                                            ht.Parameters(verbose=False,
                                                          **KW_GIANT,
                                                          **mesh)), {}),
        ("own_model", "own_model", (ht.Parameters(**KW_OWN),), {}),
        ("f64_gather", "solve", (_port(_lp(LP21)), _quiet(
            ht.Parameters, spmv_backend="gather", **KW_F64, **mesh)), {}),
        ("f64_dense", "solve", (_port(_lp(LP21)), _quiet(
            ht.Parameters, spmv_backend="dense", **KW_F64, **mesh)), {}),
        ("agree_tiles", "agree", (_port(_lp(LP21)), AGREE["tiles"]), {}),
        ("agree_gather", "agree", (_port(_lp(LP21)), AGREE["gather"]), {}),
    ]


# The autotune's agreement: each rank's scripted probe seconds by backend.
# The ranks' maxima choose what one rank's own seconds would not: in
# "tiles" rank 0's alone pick "gather" and rank 1's "dense"; in "gather"
# rank 1's alone keep the tiles ("gather" is less than 5% faster there).
AGREE = {
    "tiles": [{"tiled": 1.0, "gather": 0.5, "dense": 2.0},
              {"tiled": 1.0, "gather": 3.0, "dense": 0.6}],
    "gather": [{"tiled": 1.0, "gather": 0.5, "dense": 2.0},
               {"tiled": 0.72, "gather": 0.7, "dense": 0.9}],
}


def _jax_references(monkeypatch):
    mesh = {"mesh_shape": JAX_DEVICES}
    out = {
        "f64": jax_solve(_lp(LP21), _quiet(JaxParameters, **KW_F64, **mesh)),
        "f64_dense": jax_solve(_lp(LP21), _quiet(
            JaxParameters, spmv_backend="dense", **KW_F64, **mesh)),
        "lane": jax_solve(_lp(LP32),
                          _quiet(JaxParameters, **KW_LANE, **mesh)),
        "batched": jax_solve_batched(
            *batched_args(B), params=JaxParameters(verbose=False, **mesh)),
    }
    # JAX takes its giant route on the CPU with the variable set and its
    # constant lowered, as tests/test_parallel.py's TestGiantMesh does.
    monkeypatch.setenv("HPRLP_GIANT_LANE_FIRST_NNZ", str(ranks.GIANT))
    monkeypatch.setattr(jloop, "GIANT_LANE_FIRST_NNZ", ranks.GIANT)
    out["giant"] = jax_solve(_lp(LP42),
                             _quiet(JaxParameters, **KW_GIANT, **mesh))
    monkeypatch.undo()
    out["mixed"] = jax_solve(_lp(LP_MIXED), _quiet(JaxParameters, **KW_MIXED))
    return out


@pytest.fixture(scope="module")
def runs():
    """(every rank's {case: result}, the JAX mesh solves): the 2 ranks
    run while this process computes the JAX references."""
    got = {}

    def launch():
        try:
            got["ranks"] = distributed.launch(
                ranks.run_cases, (_cases(),), world=WORLD,
                device_type="cpu", timeout=300)
        except BaseException as e:  # re-raised in the test's thread
            got["error"] = e

    thread = threading.Thread(target=launch)
    thread.start()
    with pytest.MonkeyPatch.context() as mp:
        refs = _jax_references(mp)
    thread.join(timeout=330)
    assert not thread.is_alive(), "the launch outlived its timeout"
    if "error" in got:
        raise got["error"]
    return got["ranks"], refs


def test_each_rank_is_a_fresh_gloo_rank_without_jax(runs):
    per_rank, _ = runs
    for r, out in enumerate(per_rank):
        facts = out["facts"]
        assert facts["rank"] == r and facts["world"] == WORLD
        assert facts["multihost"] and facts["devices"] == WORLD
        assert facts["backend"] == "gloo"
        assert not facts["jax"] and not facts["hprlp_tpu"]


@pytest.mark.parametrize("case", ["f64", "lane", "giant", "batched",
                                  "model", "mixed", "presolve_once",
                                  "overlap_reuse", "overlap_discard",
                                  "f64_gather", "f64_dense", "agree_tiles",
                                  "agree_gather"])
def test_every_rank_returns_the_same_results(runs, case):
    """Every field of every rank's result bitwise rank 0's, times
    included (the ranks agree on them)."""
    per_rank, _ = runs

    def results(out):
        got = out[case]
        return got[0] if isinstance(got, tuple) else got

    for out in per_rank[1:]:
        same_results(results(out), results(per_rank[0]))


def test_mixed_on_the_mesh_matches_one_card_and_jax(runs):
    """precision="mixed" (f64 stages) on 2 ranks, every stage a mesh
    solve: OPTIMAL at 1e-8 in host f64, as the one-card "mixed" solve
    and the JAX package's; the objective within rel 1e-6 of both; the
    iterations within 25% of the one-card count, which is JAX's (the
    mesh sums each SpMV in two partials, so its bits differ)."""
    per_rank, refs = runs
    got, jax = per_rank[0]["mixed"], refs["mixed"]
    problem = _port(_lp(LP_MIXED))
    one = ht.solve_problem(problem, _quiet(ht.Parameters, **KW_MIXED),
                           device="cpu")
    assert got.status == one.status == jax.status == "OPTIMAL"
    assert problem.kkt_error(got.x, got.y, got.z)["kkt"] < 1e-8
    for want in (one, jax):
        assert got.primal_obj == pytest.approx(want.primal_obj, rel=1e-6,
                                               abs=1e-6)
    assert one.iter == jax.iter
    assert abs(got.iter - one.iter) <= 0.25 * one.iter


def test_presolve_runs_once_per_mesh(runs):
    """Model.solve on 2 ranks, rank 1's presolve made to fail: rank 0
    presolves once, rank 1 never, and both return rank 0's outcome
    (fixed_block, which presolve reduces) with the single-device
    Model.solve's status and objective to rel 1e-6."""
    per_rank, _ = runs
    calls = [out["presolve_once"][1] for out in per_rank]
    assert calls == [1, 0]
    records = [out["presolve_once"][3] for out in per_rank]
    assert [r["presolved"] for r in records] == [True, False]
    assert all(r["broadcast_bytes"] > 0 for r in records)
    got = per_rank[0]["presolve_once"][0]
    want = ht.Model(_port(_fixed_block())).solve(
        ht.Parameters(verbose=False, **KW_GIANT), device="cpu")
    assert got.status == want.status == "OPTIMAL"
    assert got.presolve_time > 0
    assert got.primal_obj == pytest.approx(want.primal_obj, rel=1e-6)


@pytest.mark.parametrize("case,ingests", [("overlap_reuse", 1),
                                          ("overlap_discard", 2)])
def test_overlap_on_the_mesh(runs, case, ingests):
    """The giant regime under a mesh (loop.GIANT_LANE_FIRST_NNZ lowered
    in the ranks): rank 0 presolves once beside every rank's share ingest
    of the original; where presolve removes at most REINGEST_SHARE of nnz
    (random7) every rank solves on that ingest (one ingest), else on the
    reduced problem's (two); OPTIMAL with the single-device overlap's
    objective to rel 1e-4 (the mesh's f32 sums differ)."""
    per_rank, _ = runs
    assert [out[case][1] for out in per_rank] == [1, 0]
    assert [out[case][2] for out in per_rank] == [ingests, ingests]
    got = per_rank[0][case][0]
    problem = (_port(_lp(LP7)) if case == "overlap_reuse"
               else _port(_fixed_block()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ht.solver.loop, "GIANT_LANE_FIRST_NNZ", ranks.GIANT)
        want = ht.Model(problem).solve(
            ht.Parameters(verbose=False, **KW_GIANT), device="cpu")
    assert got.status == want.status == "OPTIMAL"
    assert got.presolve_time > 0
    assert got.primal_obj == pytest.approx(want.primal_obj, rel=1e-4,
                                           abs=1e-4)


def test_f64_lp_matches_the_jax_mesh_solve(runs):
    """tests/test_parallel.py:28's LP at 1e-6 in f64: the JAX mesh solve's
    status, its objective to rel 1e-6 and its x to atol 1e-5; the port's
    single-device solve's iteration count."""
    per_rank, refs = runs
    got, want = per_rank[0]["f64"], refs["f64"]
    assert got.status == want.status == "OPTIMAL"
    assert got.spmv_backend == "tiled"
    assert got.primal_obj == pytest.approx(want.primal_obj, rel=1e-6)
    np.testing.assert_allclose(got.x, want.x, atol=1e-5)
    single = ht.solve_problem(_port(_lp(LP21)),
                              _quiet(ht.Parameters, **KW_F64), device="cpu")
    assert got.iter == single.iter


@pytest.mark.parametrize("backend", ["gather", "dense"])
def test_row_sharded_lp_matches_the_jax_mesh_solve(runs, backend):
    """tests/test_parallel.py:28's LP at 1e-6 in f64 with spmv_backend
    "gather" and "dense", A and A^T row-sharded on 2 ranks, against the
    JAX package's mesh solve with the same backend on 8 devices (its
    "auto" takes "gather" on the CPU, the "f64" reference): its status,
    backend and iterations, the objective to rel 1e-9 and x to atol
    1e-7; and bitwise the port's one-card solve with that backend."""
    per_rank, refs = runs
    got = per_rank[0][f"f64_{backend}"]
    want = refs["f64" if backend == "gather" else "f64_dense"]
    assert want.spmv_backend == got.spmv_backend == backend
    assert got.status == want.status == "OPTIMAL"
    assert got.iter == want.iter
    assert got.primal_obj == pytest.approx(want.primal_obj, rel=1e-9)
    np.testing.assert_allclose(got.x, want.x, atol=1e-7)
    one = ht.solve_problem(_port(_lp(LP21)), _quiet(
        ht.Parameters, spmv_backend=backend, **KW_F64), device="cpu")
    assert got.iter == one.iter and got.primal_obj == one.primal_obj
    np.testing.assert_array_equal(got.x, one.x)


@pytest.mark.parametrize("case", sorted(AGREE))
def test_the_ranks_take_the_slowest_ranks_choice(runs, case):
    """The autotune on 2 ranks whose probe seconds differ (AGREE): every
    rank reports each backend's seconds as the ranks' maximum beside its
    own, takes the choice those maxima make, releases the losers' forms
    (the row shards when the tiles win, the tiles when "gather" does) and
    solves to OPTIMAL on it."""
    per_rank, _ = runs
    times = AGREE[case]
    want = {k: max(t[k] for t in times) for k in times[0]}
    for r, out in enumerate(per_rank):
        res, rec, kept = out[f"agree_{case}"]
        assert rec["seconds"] == want
        assert rec["rank_seconds"] == times[r]
        assert rec["choice"] == res.spmv_backend == (
            "tiled" if case == "tiles" else "gather")
        assert kept == [(case == "tiles", case != "tiles")] * 2
        assert res.status == "OPTIMAL"


def test_f32_lane_lp_matches_the_jax_mesh_solve(runs):
    """tests/test_parallel.py:124's f32 lane case at its tolerances: both
    OPTIMAL, objectives to rel 1e-4 (abs 1e-4), x to atol 5e-3; the port
    runs its tiled kernel (the JAX package's "lane")."""
    per_rank, refs = runs
    got, want = per_rank[0]["lane"], refs["lane"]
    assert want.spmv_backend == "lane" and got.spmv_backend == "tiled"
    assert got.status == want.status == "OPTIMAL"
    assert got.primal_obj == pytest.approx(want.primal_obj, rel=1e-4,
                                           abs=1e-4)
    np.testing.assert_allclose(got.x, want.x, atol=5e-3)


def test_giant_lp_matches_the_jax_giant_mesh_solve(runs):
    """tests/test_parallel.py:204's giant case (both packages' giant
    constants lowered to 100 inside the solve): both OPTIMAL, objectives
    to rel 1e-3 (abs 1e-3), x to atol 2e-2."""
    per_rank, refs = runs
    got, want = per_rank[0]["giant"], refs["giant"]
    assert want.spmv_backend == "lane" and got.spmv_backend == "tiled"
    assert got.status == want.status == "OPTIMAL"
    assert got.primal_obj == pytest.approx(want.primal_obj, rel=1e-3,
                                           abs=1e-3)
    np.testing.assert_allclose(got.x, want.x, atol=2e-2)


def test_batched_matches_the_jax_mesh_solve(runs):
    """tests/test_parallel.py:66's batched case, B=16: the JAX mesh
    solve's statuses, objectives to rtol 1e-5 (atol 1e-6); each rank's
    members gathered in order (x of shape (n, B), column-major)."""
    per_rank, refs = runs
    got, want = per_rank[0]["batched"], refs["batched"]
    assert list(got.status) == list(want.status)
    np.testing.assert_allclose(got.primal_obj, want.primal_obj, rtol=1e-5,
                               atol=1e-6)
    assert got.x.shape == (18, B) and got.x.flags.f_contiguous
    single = ht.solve_batched(*batched_args(B),
                              params=ht.Parameters(verbose=False),
                              device="cpu")
    np.testing.assert_array_equal(got.iter, single.iter)


def test_model_solve_presolves_then_solves_on_the_mesh(runs):
    """Model.solve with mesh_shape: presolve, the mesh solve of the reduced
    LP, postsolve: OPTIMAL with the single-device Model.solve's objective
    to rel 1e-6."""
    per_rank, _ = runs
    got = per_rank[0]["model"]
    want = ht.Model(_port(_lp(LP21))).solve(
        ht.Parameters(verbose=False, stop_tol=1e-6), device="cpu")
    assert got.status == want.status == "OPTIMAL"
    assert got.primal_obj == pytest.approx(want.primal_obj, rel=1e-6)


def test_a_rank_solves_its_own_lp_without_a_mesh(runs):
    """Model.solve without mesh_shape in a process that is a rank of a
    group (a torchrun job whose ranks each solve their own LP): every
    rank presolves and solves its own LP, and returns bitwise (times
    aside) the Results of the same call outside any group; its log is
    printed on every rank."""
    per_rank, _ = runs
    for r, out in enumerate(per_rank):
        got, record, printed = out["own_model"]
        want = ht.Model(ranks.own_model_problem(r)).solve(
            ht.Parameters(**KW_OWN), device="cpu")
        assert got.status == "OPTIMAL"
        assert record["presolved"] and record["broadcast_bytes"] == 0
        for name in ranks.loop.TIME_FIELDS + ("presolve_time",):
            setattr(want, name, getattr(got, name))
        same_results(got, want)
        assert "Presolve" in printed and "iter" in printed.lower()
