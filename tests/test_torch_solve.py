"""Whole solves of the port against JAX solve_problem (CPU, f64), and the
port's entry points: statuses, warm starts, devices, precision routing and
the options it does not take yet (a mesh with the "gather" or "dense"
backend)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu.params import Parameters as JaxParameters
from hprlp_tpu.problem import LpProblem as JaxLpProblem
from hprlp_tpu.solver.loop import solve_problem as jax_solve
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.solver.loop import resolve_dtype

from conftest import random_lp as jax_random_lp

# The tensors here are small: one intra-op thread keeps this test worker
# from competing with the suite's other workers for cores.
torch.set_num_threads(1)


def _assignment(n, seed=0):
    """benchmarks/run.py::assignment_problem's arrays."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0.0, 1.0, (n, n))
    k = np.arange(n * n)
    A = sp.coo_matrix((np.ones(2 * n * n),
                       (np.concatenate([k // n, n + k % n]),
                        np.concatenate([k, k]))), shape=(2 * n, n * n))
    ones = np.ones(2 * n)
    return (A.tocsr(), ones, ones, np.zeros(n * n), np.ones(n * n),
            cost.ravel())


def _arrays(jprob):
    return (jprob.A, jprob.AL, jprob.AU, jprob.l, jprob.u, jprob.c)


CASES = {
    "demo": lambda: (sp.csr_matrix(np.array([[1.0, 2.0], [3.0, 1.0]])),
                     [-np.inf, -np.inf], [10.0, 12.0], [0.0, 0.0],
                     [np.inf, np.inf], [-3.0, -5.0]),
    "random_lp0": lambda: _arrays(jax_random_lp(0)),
    "random_lp1": lambda: _arrays(jax_random_lp(1)),
    "random_lp2": lambda: _arrays(jax_random_lp(2)),
    "assignment16": lambda: _assignment(16),
}


def _pair(args, **kw):
    jp = JaxParameters(verbose=False, **kw)
    tp = ht.Parameters(verbose=False, **kw)
    return (jax_solve(JaxLpProblem.from_arrays(*args), jp),
            ht.solve_problem(LpProblem.from_arrays(*args), tp, device="cpu"))


@pytest.mark.parametrize("stall_recovery", [50, 0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_matches_jax(case, stall_recovery):
    rj, rt = _pair(CASES[case](), stall_recovery=stall_recovery)
    assert rt.status == rj.status == "OPTIMAL"
    assert rt.primal_obj == pytest.approx(rj.primal_obj, rel=1e-6, abs=1e-6)
    assert rt.iter == rj.iter
    for k in ("iter4", "iter6", "iter8", "restarts", "stall_recoveries"):
        assert getattr(rt, k) == getattr(rj, k), k
    assert rt.spmv_backend == "tiled"
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-6, atol=1e-6)
    if case == "demo":
        assert rt.primal_obj == pytest.approx(-26.4, abs=1e-3)


def test_iter_limit_and_warm_start_match_jax():
    args = CASES["random_lp1"]()
    rj, rt = _pair(args, max_iter=300)
    assert rt.status == rj.status == "ITER_LIMIT"
    assert rt.iter == rj.iter == 300
    jw = jax_solve(JaxLpProblem.from_arrays(*args),
                   JaxParameters(verbose=False), x0=rj.x, y0=rj.y,
                   sigma0=rj.sigma_final)
    tw = ht.solve_problem(LpProblem.from_arrays(*args),
                          ht.Parameters(verbose=False), x0=rt.x, y0=rt.y,
                          sigma0=rt.sigma_final, device="cpu")
    assert tw.status == jw.status == "OPTIMAL"
    assert tw.iter == jw.iter
    assert tw.primal_obj == pytest.approx(jw.primal_obj, rel=1e-6)


def test_f32_solve_on_cpu():
    prob = LpProblem.from_arrays(*CASES["random_lp0"]())
    res = ht.solve_problem(prob, ht.Parameters(verbose=False, precision="f32"),
                           device="cpu")
    assert res.status == "OPTIMAL"
    assert prob.kkt_error(res.x, res.y, res.z)["kkt"] < 1e-3


def test_model_prints_presolve_posture_and_applies_sense(capsys):
    """Presolve is on by default, as in the JAX package, and runs quietly."""
    args = CASES["demo"]()
    res = ht.solve(*args, ht.Parameters(verbose=False), device="cpu")
    assert res.status == "OPTIMAL"
    assert res.presolve_time > 0.0
    assert capsys.readouterr().err == ""
    off = ht.solve(*args, ht.Parameters(verbose=False, use_presolve=False),
                   device="cpu")
    assert capsys.readouterr().err == ""
    assert off.presolve_time == 0.0
    for r in (res, off):
        assert r.primal_obj == pytest.approx(-26.4, abs=1e-3)
    prob = LpProblem.from_arrays(*args)
    prob.objective_sense = -1
    res_max = ht.Model(prob).solve(
        ht.Parameters(verbose=False, use_presolve=False), device="cpu")
    assert res_max.primal_obj == pytest.approx(-off.primal_obj)


def test_verbose_solve_logs_progress(capsys):
    res = ht.solve(*CASES["demo"](),
                   ht.Parameters(use_presolve=False), device="cpu")
    out = capsys.readouterr().out
    assert res.status == "OPTIMAL"
    assert "Solution Summary" in out and "Residual < 1e-04" in out


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ht.solve(*CASES["demo"](), ht.Parameters(verbose=False))


@pytest.mark.parametrize("kw", [
    {"mesh_shape": 2, "spmv_backend": "gather"},
    {"mesh_shape": 2, "spmv_backend": "dense"},
    {"mesh_shape": 2, "precision": "mixed", "spmv_backend": "gather"},
], ids=["kw1", "kw2", "kw3"])
def test_options_not_ported_raise(kw):
    """The options a mesh once refused (spmv_backend "gather" and
    "dense", precision="mixed" with "gather") now run on 2 gloo ranks:
    OPTIMAL on the backend asked for, the one-card solve's objective to
    rel 1e-6."""
    problem = LpProblem.from_arrays(*CASES["demo"]())
    got = ht.solve_problem(problem, ht.Parameters(verbose=False, **kw),
                           device="cpu")
    one = ht.solve_problem(problem, ht.Parameters(
        verbose=False, **{k: v for k, v in kw.items() if k != "mesh_shape"}),
        device="cpu")
    assert got.status == one.status == "OPTIMAL"
    assert got.spmv_backend == kw["spmv_backend"]
    assert got.primal_obj == pytest.approx(one.primal_obj, rel=1e-6)


def test_precision_routing():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    P = ht.Parameters
    assert resolve_dtype(P(), cpu) == torch.float64
    assert resolve_dtype(P(stop_tol=1e-4), cuda) == torch.float32
    assert resolve_dtype(P(stop_tol=1e-5), cuda) == torch.float32
    assert resolve_dtype(P(stop_tol=1e-8), cuda) == torch.float64
    assert resolve_dtype(P(precision="f32"), cpu) == torch.float32
    assert resolve_dtype(P(precision="f64", stop_tol=1e-4), cuda) \
        == torch.float64
