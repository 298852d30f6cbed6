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
    ]


def _jax_references(monkeypatch):
    mesh = {"mesh_shape": JAX_DEVICES}
    out = {
        "f64": jax_solve(_lp(LP21), _quiet(JaxParameters, **KW_F64, **mesh)),
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
                                  "model"])
def test_every_rank_returns_the_same_results(runs, case):
    """Every field of every rank's result bitwise rank 0's, times
    included (the ranks agree on them)."""
    per_rank, _ = runs
    for out in per_rank[1:]:
        same_results(out[case], per_rank[0][case])


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
