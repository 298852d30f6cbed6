"""The single-LP SpMV backend autotune (hprlp_tpu_torch/solver/autotune.py)
against the JAX package's (hprlp_tpu/solver/autotune.py), the backends it
can choose, and the CLI flag that forces one (CPU).

The decision rule is held to JAX's with both modules' `_time_chunk`
patched, in the test only, to the same scripted times and metrics, and
both told that their fast kernel is available (JAX's `jax.default_backend`
and the port's `_lane_ok` patched; the JAX problem in f32, which its f64
lane pin leaves alone).  The two name their backends otherwise: JAX's
baseline is its gather SpMV and its candidates its lane kernel and a dense
product, in that order; the port's baseline is the tiled kernel and its
candidates the CSR kernel ("gather") and a dense product.  So the script
gives times by role: the baseline, the other kernel, the dense product."""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu.ops.device_problem import build_device_problem as jax_build
from hprlp_tpu.params import Parameters as JaxParameters
from hprlp_tpu.problem import LpProblem as JaxLpProblem
from hprlp_tpu.solver import autotune as jat
from hprlp_tpu.solver.loop import solve_problem as jax_solve
from hprlp_tpu_torch import cli
from hprlp_tpu_torch.ops.device_problem import (attach_tiles,
                                                build_device_problem)
from hprlp_tpu_torch.ops.sparse import spmv_backend
from hprlp_tpu_torch.ops.tiles import build_tiles
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.solver import autotune as tat

from conftest import random_lp as jax_random_lp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "data", "model.mps")

JAX_ROLE = {("gather", "gather"): "base", ("lane", "lane"): "other",
            ("dense", "dense"): "dense"}
PORT_ROLE = {"tiled": "base", "dense": "dense", "gather": "other"}


def _arrays(m, n, density, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x
    return A, Ax - 1.0, Ax + 1.0, x - 2.0, x + 2.0, rng.normal(size=n)


def _lps(arrays, jax_dtype=np.float32):
    """The JAX package's device problem and the port's (with its tiles, as
    the solve attaches them before the autotune)."""
    lp_j, _ = jax_build(JaxLpProblem.from_arrays(*arrays), dtype=jax_dtype)
    lp_t, _ = build_device_problem(LpProblem.from_arrays(*arrays),
                                   dtype=torch.float64, device="cpu")
    lp_t = attach_tiles(lp_t, build_tiles(lp_t.A), build_tiles(lp_t.AT))
    return lp_j, lp_t


def _script(monkeypatch, times, rp_off=None, fail=None):
    """Patch both _time_chunk functions: a probe of role r takes times[r]
    seconds and reports nrm_Rp = 1 (times 1 + rp_off[r] where given); the
    role `fail` raises.  Returns the roles probed, per package."""
    probed = {"jax": [], "port": []}

    def answer(role):
        if role == fail:
            raise RuntimeError("stand-in probe failure")
        rp = 1.0 + (rp_off or {}).get(role, 0.0)
        return times[role], {"nrm_Rp": rp, "nrm_Rd": 1.0}

    def jax_time(run, lp, args, n_rep=2):
        role = JAX_ROLE[lp.A.backend, lp.AT.backend]
        probed["jax"].append(role)
        return answer(role)

    def port_time(lp, probe_args, counts):
        assert spmv_backend(lp.A) == spmv_backend(lp.AT)
        role = PORT_ROLE[spmv_backend(lp.A)]
        probed["port"].append(role)
        return answer(role)

    monkeypatch.setattr(jat, "_time_chunk", jax_time)
    monkeypatch.setattr(tat, "_time_chunk", port_time)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(tat, "_lane_ok", lambda lp: True)
    return probed


def _choices(lp_j, lp_t):
    got_j = jat.autotune_backends(None, lp_j, ())
    got_t = tat.autotune_backends(lp_t, ())
    return (JAX_ROLE[got_j.A.backend, got_j.AT.backend],
            PORT_ROLE[spmv_backend(got_t.A)])


# (times by role, nrm_Rp offsets by role, failing role, expected choice)
RULES = {
    "dense_4pc_faster_kept_out": ({"base": 1.0, "dense": 0.96,
                                   "other": 2.0}, None, None, "base"),
    "dense_6pc_faster_taken": ({"base": 1.0, "dense": 0.94, "other": 2.0},
                               None, None, "dense"),
    "merit_1.1pc_off_rejected": ({"base": 1.0, "dense": 0.5, "other": 2.0},
                                 {"dense": 0.011}, None, "base"),
    "merit_0.9pc_off_taken": ({"base": 1.0, "dense": 0.5, "other": 2.0},
                              {"dense": -0.009}, None, "dense"),
    "failing_probe_keeps_baseline": ({"base": 1.0, "dense": 0.5,
                                      "other": 2.0}, None, "dense", "base"),
    "other_taken_dense_not_5pc_better": ({"base": 1.0, "dense": 0.92,
                                          "other": 0.94}, None, None,
                                         "other"),
    "dense_5pc_better_than_other": ({"base": 1.0, "dense": 0.80,
                                     "other": 0.94}, None, None, "dense"),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_decision_rule_matches_jax(rule, monkeypatch, capsys):
    """A dense-eligible LP (12,000 nnz, 18% dense before padding): both
    probe their baseline, the other kernel and the dense product, in that
    order, and choose the same role."""
    times, rp_off, fail, want = RULES[rule]
    lp_j, lp_t = _lps(_arrays(150, 400, 0.2))
    assert lp_t.A.nnz >= tat.AUTOTUNE_MIN_NNZ
    probed = _script(monkeypatch, times, rp_off, fail)
    assert _choices(lp_j, lp_t) == (want, want)
    assert probed["jax"] == probed["port"] == ["base", "other", "dense"]
    if fail:
        assert "probe failed" in capsys.readouterr().err
    rec = tat.autotune_backends.record
    assert rec["choice"] == {v: k for k, v in PORT_ROLE.items()}[want]
    assert rec["failed"] == ([] if fail is None else ["dense"])
    assert rec["merit_rejected"] == (["dense"] if rule.startswith(
        "merit_1.1") else [])


def test_below_the_probe_threshold_nothing_is_probed(monkeypatch):
    lp_j, lp_t = _lps(_arrays(40, 60, 0.3))
    assert lp_t.A.nnz < tat.AUTOTUNE_MIN_NNZ == jat.AUTOTUNE_MIN_NNZ
    probed = _script(monkeypatch, {"base": 1.0, "dense": 0.1, "other": 0.1})
    assert _choices(lp_j, lp_t) == ("base", "base")
    assert probed == {"jax": [], "port": []}
    assert tat.autotune_backends.record is None


def test_at_the_direct_threshold_the_fast_kernel_is_taken(monkeypatch):
    """With the direct threshold below the LP's nnz, JAX (on an
    accelerator, f32) takes its lane kernel and the port its tiled kernel,
    neither by a probe."""
    lp_j, lp_t = _lps(_arrays(150, 400, 0.2))
    probed = _script(monkeypatch, {"base": 1.0, "dense": 0.1, "other": 0.1})
    monkeypatch.setattr(jat, "AUTOTUNE_LANE_DIRECT_NNZ", 1000)
    monkeypatch.setattr(tat, "AUTOTUNE_LANE_DIRECT_NNZ", 1000)
    smoke = []

    def run(lp, *args):
        smoke.append(lp.A.backend)
        return None, {"nrm_Rp": 1.0}

    got_j = jat.autotune_backends(run, lp_j, ())
    got_t = tat.autotune_backends(lp_t, ())
    assert got_j.A.backend == "lane" and got_t is lp_t
    assert spmv_backend(got_t.A) == "tiled"
    assert probed == {"jax": [], "port": []} and smoke == ["lane"]


def test_a_sparse_lp_probes_no_dense_product(monkeypatch):
    """At 0.2% density (12,800 nnz) neither package, with its fast kernel
    available, probes a dense product."""
    lp_j, lp_t = _lps(_arrays(800, 8000, 0.002))
    probed = _script(monkeypatch, {"base": 1.0, "dense": 0.1, "other": 2.0})
    assert _choices(lp_j, lp_t) == ("base", "base")
    assert probed == {"jax": ["base", "other"], "port": ["base", "other"]}


def test_the_cpu_keeps_the_tiled_route():
    """Unpatched, on the CPU, the port probes nothing."""
    _, lp_t = _lps(_arrays(150, 400, 0.2))
    assert tat.autotune_backends(lp_t, ()) is lp_t
    assert tat.autotune_backends.record is None


@pytest.mark.parametrize("backend", ["gather", "dense"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forced_backend_solves_as_jax(backend, seed, monkeypatch):
    """spmv_backend "gather" (the CSR SpMV's plain version here) and
    "dense" (the dense product only: the sparse plain versions are taken
    away) against the JAX package's solve with the same backend, f64: the
    same status and iterations, objectives within 1e-9 relative."""
    args = _arrays_of(jax_random_lp(seed))
    rj = jax_solve(JaxLpProblem.from_arrays(*args),
                   JaxParameters(verbose=False, spmv_backend=backend))
    if backend == "dense":
        from hprlp_tpu_torch.ops import sparse
        from hprlp_tpu_torch.ops import tiles

        monkeypatch.setattr(sparse, "spmv_reference", None)
        monkeypatch.setattr(sparse, "tiled_spmv_reference", None)
        monkeypatch.setattr(tiles, "build_tiles", None)
    rt = ht.solve_problem(LpProblem.from_arrays(*args),
                          ht.Parameters(verbose=False, spmv_backend=backend),
                          device="cpu")
    assert rt.status == rj.status == "OPTIMAL"
    assert rt.iter == rj.iter
    assert rt.spmv_backend == rj.spmv_backend == backend
    assert rt.primal_obj == pytest.approx(rj.primal_obj, rel=1e-9)
    assert rt.autotune_time >= 0.0


def _arrays_of(jprob):
    return (jprob.A, jprob.AL, jprob.AU, jprob.l, jprob.u, jprob.c)


def test_cli_cusparse_spmv_true_solves_on_gather(monkeypatch, capsys):
    """--cusparse-spmv true exits 0 with the CSR backend, as the JAX CLI
    maps it to its gather SpMV."""
    seen = []
    real = ht.Model.solve

    def solve(self, params, **kw):
        seen.append(params.spmv_backend)
        return real(self, params, **kw)

    monkeypatch.setattr(ht.Model, "solve", solve)
    rc = cli.main(["-i", MODEL, "--device", "cpu", "--quiet",
                   "--cusparse-spmv", "true"])
    out = capsys.readouterr().out
    assert rc == 0 and "status=OPTIMAL" in out
    assert seen == ["gather"]
