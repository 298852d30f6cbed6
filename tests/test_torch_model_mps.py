"""Model.from_mps(...).solve and solve_mps of the port against the JAX
package's, on the CPU in f64, with presolve on and off.

The reduced problems are bitwise equal (tests/test_torch_presolve.py), so
each case must take JAX's status and exactly its iteration count; the
objective agrees to 1e-9 relative and x, y, z to 1e-7 (relative and
absolute)."""

import os

import numpy as np
import pytest
import torch

import hprlp_tpu as hj
import hprlp_tpu_torch as ht
from hprlp_tpu_torch import native
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.prof.problems import structured_lp, write_mps

from conftest import random_lp as jax_random_lp
from test_torch_mps import SAMPLES
from test_torch_presolve import CASES as PRESOLVE_CASES
from test_torch_presolve import libraries  # noqa: F401 (a fixture)

# The tensors here are small: one intra-op thread keeps this test worker
# from competing with the suite's other workers for cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")


# Every case here needs both packages' host libraries.
pytestmark = pytest.mark.usefixtures("libraries")


def _written(make):
    def write(tmp_path):
        path = os.path.join(tmp_path, "lp.mps")
        write_mps(make(), path)
        return path
    return write


def _sample(name):
    def write(tmp_path):
        path = os.path.join(tmp_path, f"{name}.mps")
        with open(path, "w") as f:
            f.write(SAMPLES[name])
        return path
    return write


def _data(rel):
    return lambda tmp_path: os.path.join(DATA, rel)


def _arrays_lp(name):
    """One of tests/test_torch_presolve.py's presolve LPs, as MPS."""
    return _written(lambda: LpProblem.from_arrays(*PRESOLVE_CASES[name][0]))


# name -> (path maker, reader keywords)
FILES = {
    "model.mps": (_data("model.mps"), {}),
    "ranges_edge.mps": (_data("fixtures/ranges_edge.mps"), {}),
    "bounds_defaults.mps": (_data("fixtures/bounds_defaults.mps"), {}),
    "fixed_names.mps": (_data("fixtures/fixed_names.mps"),
                        {"mps_format": "fixed"}),
    "objsense_max": (_sample("objsense_max"), {}),
    "random_lp0": (_written(lambda: LpProblem.from_arrays(
        *_np_arrays(jax_random_lp(0)))), {}),
    "random_lp3": (_written(lambda: LpProblem.from_arrays(
        *_np_arrays(jax_random_lp(3)))), {}),
    "structured_lp_2e-4": (_written(lambda: structured_lp(scale=2e-4)), {}),
    "kitchen_sink2": (_arrays_lp("kitchen_sink2"), {}),
}


def _np_arrays(p):
    return p.A, p.AL, p.AU, p.l, p.u, p.c


def assert_same_result(rt, rj):
    assert rt.status == rj.status
    assert rt.iter == rj.iter
    assert rt.primal_obj == pytest.approx(rj.primal_obj, rel=1e-9, abs=1e-12)
    assert rt.dual_obj == pytest.approx(rj.dual_obj, rel=1e-9, abs=1e-12)
    for k in ("x", "y", "z"):
        a, b = getattr(rt, k), getattr(rj, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-7, err_msg=k)


def _solve_both(path, kw, **params):
    rj = hj.Model.from_mps(path, **kw).solve(
        hj.Parameters(verbose=False, **params))
    rt = ht.Model.from_mps(path, **kw).solve(
        ht.Parameters(verbose=False, **params), device="cpu")
    return rt, rj


@pytest.mark.parametrize("presolve", [True, False], ids=["presolve",
                                                         "no_presolve"])
@pytest.mark.parametrize("case", sorted(FILES))
def test_from_mps_solve_matches_jax(tmp_path, case, presolve):
    make, kw = FILES[case]
    rt, rj = _solve_both(make(tmp_path), kw, use_presolve=presolve)
    assert_same_result(rt, rj)
    assert rt.status == "OPTIMAL"
    assert (rt.presolve_time > 0.0) == presolve
    if case == "model.mps":
        assert rt.primal_obj == pytest.approx(-26.4, abs=1e-3)


@pytest.mark.parametrize("presolve", [True, False], ids=["presolve",
                                                         "no_presolve"])
def test_solve_mps_matches_jax(presolve):
    path = os.path.join(DATA, "model.mps")
    rj = hj.solve_mps(path, hj.Parameters(verbose=False,
                                          use_presolve=presolve))
    rt = ht.solve_mps(path, ht.Parameters(verbose=False,
                                          use_presolve=presolve),
                      device="cpu")
    assert_same_result(rt, rj)


def test_warm_start_through_maps_matches_jax(tmp_path):
    """An original-space point, projected through the presolver's maps
    onto the reduced problem, starts both solves alike.  The point is the
    JAX package's after 150 iterations, given to both."""
    path = FILES["structured_lp_2e-4"][0](tmp_path)
    cold = hj.Model.from_mps(path).solve(hj.Parameters(verbose=False,
                                                       max_iter=150))
    assert cold.status == "ITER_LIMIT"
    rt, rj = (model.from_mps(path).solve(params(verbose=False), x0=cold.x,
                                         y0=cold.y, **kw)
              for model, params, kw in ((ht.Model, ht.Parameters,
                                         {"device": "cpu"}),
                                        (hj.Model, hj.Parameters, {})))
    assert_same_result(rt, rj)
    cold_t = ht.Model.from_mps(path).solve(ht.Parameters(verbose=False),
                                           device="cpu")
    assert rt.status == cold_t.status == "OPTIMAL"
    assert rt.iter < cold_t.iter


@pytest.mark.parametrize("case", ["fixed_col", "forcing_row"])
def test_reduced_to_nothing_matches_jax(tmp_path, case):
    """Presolve removes every column: postsolve of empty vectors and the
    original-space KKT decide the status; no iteration runs."""
    rt, rj = _solve_both(_arrays_lp(case)(tmp_path), {})
    assert_same_result(rt, rj)
    assert rt.status == "OPTIMAL" and rt.iter == 0
    assert rt.time == rt.presolve_time > 0.0


@pytest.mark.parametrize("case", ["infeasible", "propagation_infeasible",
                                  "unbounded"])
def test_status_by_presolve_matches_jax(tmp_path, case):
    rt, rj = _solve_both(_arrays_lp(case)(tmp_path), {})
    assert rt.status == rj.status == PRESOLVE_CASES[case][2]
    assert rt.iter == rj.iter == 0 and rt.x is None


def test_presolve_failure_falls_back_to_the_original(monkeypatch, capsys):
    """The error boundary: a presolver that raises leaves a warning and a
    solve of the unreduced model, as in the JAX package."""
    from hprlp_tpu_torch import presolve

    def broken(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(presolve, "presolve_problem", broken)
    path = os.path.join(DATA, "model.mps")
    res = ht.solve_mps(path, ht.Parameters(verbose=False), device="cpu")
    off = ht.solve_mps(path, ht.Parameters(verbose=False, use_presolve=False),
                       device="cpu")
    assert "[presolve] failed (boom)" in capsys.readouterr().err
    assert res.status == "OPTIMAL" and res.iter == off.iter
    assert res.primal_obj == off.primal_obj


def test_from_mps_falls_back_to_the_python_reader(monkeypatch):
    """Without the host library Model.from_mps reads with io/mps.py and
    the solve runs without presolve."""
    path = os.path.join(DATA, "model.mps")
    want = ht.Model.from_mps(path).problem
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "lib_error", "no g++")
    model = ht.Model.from_mps(path)
    assert (model.problem.A != want.A).nnz == 0
    res = model.solve(ht.Parameters(verbose=False), device="cpu")
    assert res.status == "OPTIMAL" and res.presolve_time == 0.0
