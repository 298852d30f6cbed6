"""precision="mixed" on the port (hprlp_tpu_torch/solver/refine.py), on
the CPU: tests/test_solver.py's four refinement cases, the port against
the JAX package with f64 stages (the same status and iteration count, the
objective to 1e-9), the batched "mixed" route against the JAX package's,
and the CLI."""

import os

import numpy as np
import pytest
import torch

import hprlp_tpu as hj
import hprlp_tpu_torch as ht
from hprlp_tpu_torch import cli
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.results import Results
from hprlp_tpu_torch.solver import loop as loop_mod
from hprlp_tpu_torch.solver import refine
from hprlp_tpu_torch.solver.loop import resolve_dtype

from conftest import random_lp as jax_random_lp
from test_torch_batched import CASES as BATCHED_CASES
from test_torch_presolve import libraries  # noqa: F401 (a fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "data", "model.mps")


def port_lp(seed, **kw):
    p = jax_random_lp(seed, **kw)
    return LpProblem.from_arrays(p.A, p.AL, p.AU, p.l, p.u, p.c)


def quiet(**kw):
    return ht.Parameters(verbose=False, use_presolve=False, **kw)


def test_refined_reaches_1e8():
    prob = port_lp(41, m=40, n=60, density=0.25)
    res = ht.solve_problem(prob, quiet(stop_tol=1e-8, precision="mixed"),
                           device="cpu")
    assert res.status == "OPTIMAL"
    m = prob.kkt_error(res.x, res.y, res.z)
    assert m["kkt"] < 1e-8
    assert res.residuals == m["kkt"]


def test_refined_matches_f64():
    """The JAX package's bar: the objective within 1e-6 of a direct f64
    solve (the f32 stages' operations are not JAX's, so no count is
    compared)."""
    prob = port_lp(42, m=30, n=45, density=0.3)
    r64 = ht.solve_problem(prob, quiet(stop_tol=1e-8, precision="f64"),
                           device="cpu")
    rmx = ht.solve_problem(prob, quiet(stop_tol=1e-8, precision="mixed"),
                           device="cpu")
    assert rmx.status == "OPTIMAL"
    assert rmx.primal_obj == pytest.approx(r64.primal_obj, rel=1e-6,
                                           abs=1e-6)
    assert prob.kkt_error(rmx.x, rmx.y, rmx.z)["kkt"] < 1e-8
    # Results.time is the sum of the stages' own clocks, not wall time.
    assert 0.0 < rmx.time and rmx.iter > r64.iter


def test_f32_alone_insufficient_on_same_instance():
    """The refinement test means something only if one plain f32 solve
    does not reach 1e-8 in host f64."""
    prob = port_lp(41, m=40, n=60, density=0.25)
    res = ht.solve_problem(prob, quiet(stop_tol=1e-8, precision="f32",
                                       max_iter=20000), device="cpu")
    m = prob.kkt_error(res.x, res.y, res.z)
    assert res.status != "OPTIMAL" or m["kkt"] >= 1e-8


def test_stage_optimal_does_not_leak_to_caller(monkeypatch):
    """A stage's OPTIMAL certifies only its own tolerance: when the target
    is never met, solve_refined must not report OPTIMAL."""
    prob = port_lp(43, m=20, n=30, density=0.4)
    calls = []

    def fake_solve(problem, params, x0=None, y0=None, sigma0=None,
                   device=None):
        calls.append((params.precision, device))
        r = Results()
        r.status = "OPTIMAL"  # the stage's own tolerance, not ours
        r.x = np.zeros(problem.n)
        r.y = np.zeros(problem.m)
        r.z = np.zeros(problem.n)
        r.iter = 10
        r.spmv_backend = "tiled"
        return r

    # refine imports solve_problem lazily from .loop: patch it there.
    monkeypatch.setattr(loop_mod, "solve_problem", fake_solve)
    res = refine.solve_refined(prob, quiet(stop_tol=1e-8, precision="mixed"),
                               device="cpu")
    assert res.status == "STALLED"
    assert res.residuals >= 1e-8
    # f32 stages, then the warm and the cold f64 tail, all on the device.
    assert calls[0] == ("f32", "cpu") and calls[-2:] == [("f64", "cpu")] * 2
    assert res.iter == 10 * len(calls)


@pytest.mark.parametrize("seed,m,n,density", [(42, 30, 45, 0.3),
                                              (7, 25, 40, 0.3)])
def test_f64_stages_match_jax(seed, m, n, density):
    """refine_stage_precision="f64": native f64 stages here, JAX's f64 on
    its CPU: the same status and iteration count."""
    jp = jax_random_lp(seed, m=m, n=n, density=density)
    kw = dict(stop_tol=1e-8, precision="mixed", refine_stage_precision="f64",
              use_presolve=False, verbose=False)
    rj = hj.solve_problem(jp, hj.Parameters(**kw))
    rt = ht.solve_problem(port_lp(seed, m=m, n=n, density=density),
                          ht.Parameters(**kw), device="cpu")
    assert rt.status == rj.status == "OPTIMAL"
    assert rt.iter == rj.iter
    assert (rt.iter4, rt.iter6, rt.iter8) == (rj.iter4, rj.iter6, rj.iter8)
    assert rt.primal_obj == pytest.approx(rj.primal_obj, rel=1e-9)
    assert rt.dual_obj == pytest.approx(rj.dual_obj, rel=1e-9)


def test_mixed_model_solve_with_presolve_matches_jax(libraries):
    """Model.solve with presolve on, f64 stages: presolve, refinement on
    the reduced LP, postsolve, as the JAX package runs them."""
    jp = jax_random_lp(3)
    kw = dict(stop_tol=1e-8, precision="mixed", refine_stage_precision="f64",
              verbose=False)
    args = (jp.A, jp.AL, jp.AU, jp.l, jp.u, jp.c)
    rj = hj.Model.from_arrays(*args).solve(hj.Parameters(**kw))
    rt = ht.Model.from_arrays(*args).solve(ht.Parameters(**kw), device="cpu")
    assert rt.status == rj.status == "OPTIMAL"
    assert rt.iter == rj.iter
    assert rt.primal_obj == pytest.approx(rj.primal_obj, rel=1e-9)


@pytest.mark.parametrize("case", sorted(BATCHED_CASES))
def test_batched_mixed_matches_jax(case):
    """The JAX package's solve_batched has no refinement: "mixed" solves
    in f64 on the CPU.  The port's takes the same route: the same
    per-member statuses and iteration counts, objectives to 1e-9."""
    args, kw, oc = BATCHED_CASES[case]()
    kw = dict(kw, precision="mixed", verbose=False)
    rj = hj.solve_batched(*args, obj_constants=oc,
                          params=hj.Parameters(**kw))
    rt = ht.solve_batched(*args, obj_constants=oc,
                          params=ht.Parameters(**kw), device="cpu")
    assert rt.status == rj.status
    np.testing.assert_array_equal(rt.iter, rj.iter)
    np.testing.assert_allclose(rt.primal_obj, rj.primal_obj, rtol=1e-9,
                               atol=1e-12)


def test_mixed_dtype_routes():
    """"mixed" reaches resolve_dtype only from solve_batched: f64 on the
    CPU, f32 on CUDA; "auto" keeps its rule."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    P = ht.Parameters
    assert resolve_dtype(P(precision="mixed"), cpu) == torch.float64
    assert resolve_dtype(P(precision="mixed", stop_tol=1e-8), cuda) \
        == torch.float32
    assert resolve_dtype(P(stop_tol=1e-8), cuda) == torch.float64


def test_mixed_routes_to_refinement_on_the_device(monkeypatch):
    got = {}

    def fake(problem, params, x0=None, y0=None, device=None):
        got.update(precision=params.precision, device=device, x0=x0)
        return Results(status="OPTIMAL")

    monkeypatch.setattr(refine, "solve_refined", fake)
    prob = port_lp(0)
    x0 = np.zeros(prob.n)
    res = ht.solve_problem(prob, quiet(precision="mixed"), x0=x0,
                           device="cpu")
    assert res.status == "OPTIMAL"
    assert got["precision"] == "mixed" and got["x0"] is x0
    assert got["device"] == torch.device("cpu")


def test_cli_precision_mixed_solves(tmp_path, libraries, capsys):
    out = tmp_path / "sol.txt"
    rc = cli.main(["-i", MODEL, "--device", "cpu", "--precision", "mixed", "--tol",
                   "1e-8", "--quiet", "--solution-out", str(out)])
    assert rc == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("status=OPTIMAL ")
    head = dict(x.split(" ", 1) for x in out.read_text().splitlines()[:7])
    assert float(head["primal_obj"]) == pytest.approx(-26.4, abs=1e-6)
    assert float(head["residuals"]) < 1e-8
