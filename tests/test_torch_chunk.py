"""The port's HPR chunk, restart/sigma decisions and superchunk loop against
the JAX package, started from the same point through hprlp_tpu_torch.convert
(CPU, f64 unless stated)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from hprlp_tpu.ops.device_problem import build_device_problem as jax_build
from hprlp_tpu.ops.sparse import to_coo
from hprlp_tpu.solver import chunk as jchunk
from hprlp_tpu.solver import device_loop as jloop
from hprlp_tpu.solver.power_iteration import power_method as jax_power
from hprlp_tpu.solver.scaling import ScalingInfo as JaxScalingInfo
from hprlp_tpu.solver.scaling import scale_problem as jax_scale
from hprlp_tpu_torch import convert
from hprlp_tpu_torch.solver import chunk as tchunk
from hprlp_tpu_torch.solver import device_loop as tloop

from conftest import random_lp as jax_random_lp

# The tensors here are small: one intra-op thread keeps this test worker
# from competing with the suite's other workers for cores.
torch.set_num_threads(1)

F64 = torch.float64
CHECK = 150
STATE_VECS = ("x", "y", "last_x", "last_y", "x_bar", "y_bar", "z_bar",
              "y_obj")
RD_FLOATS = ("last_gap", "current_gap", "save_gap", "best_gap", "best_sigma",
             "inner", "best_kkt")


def _fields_np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def pair():
    """(JAX scaled problem, scaling, lambda, maps) and the port's copies."""
    lp_j, maps = jax_build(jax_random_lp(0), dtype=np.float64)
    lp_j, scal_j = jax_scale(lp_j)
    lam = float(jax_power(lp_j)) * 1.01
    d = {"A": (*to_coo(lp_j.A), lp_j.m, lp_j.n),
         "AT": (*to_coo(lp_j.AT), lp_j.n, lp_j.m)}
    d.update({k: np.asarray(getattr(lp_j, k))
              for k in ("AL", "AU", "c", "l", "u")})
    lp_t = convert.lp_device_from_numpy(d)
    scal_t = convert.scaling_from_numpy(_fields_np(scal_j))
    return lp_j, scal_j, lam, maps, lp_t, scal_t


def _random_state(rng, lp_j, maps, inner=7):
    def vec(size, pos):
        v = np.zeros(size)
        v[pos] = rng.normal(size=len(pos))
        return v

    d = {}
    for k in STATE_VECS:
        space = "n" if k in ("x", "last_x", "x_bar", "z_bar") else "m"
        d[k] = (vec(lp_j.n, maps.col_pos) if space == "n"
                else vec(lp_j.m, maps.row_pos))
    d["inner"] = inner
    return d


def _jax_state(d):
    return jchunk.SolverState(
        **{k: jnp.asarray(d[k]) for k in STATE_VECS},
        inner=jnp.asarray(d["inner"], jnp.int32))


def _close(a, b, rtol, what):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    atol = rtol * max(1.0, float(np.abs(b).max()) if b.size else 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("restart", [False, True])
def test_run_chunk_matches_jax(pair, restart):
    lp_j, scal_j, lam, maps, lp_t, scal_t = pair
    d = _random_state(np.random.default_rng(1), lp_j, maps)
    sigma = 0.7
    st_j, m_j = jchunk.run_chunk(lp_j, scal_j, _jax_state(d),
                                 jnp.asarray(sigma), jnp.asarray(lam),
                                 jnp.asarray(restart),
                                 jnp.asarray(20, jnp.int32))
    st_t, m_t = tchunk.run_chunk(lp_t, scal_t, convert.state_from_numpy(d),
                                 torch.tensor(sigma, dtype=F64),
                                 torch.tensor(lam, dtype=F64),
                                 torch.tensor(restart), 20)
    assert set(m_t) == set(m_j)
    for k in m_j:
        _close(float(m_t[k]), float(m_j[k]), 1e-10, k)
    for k in STATE_VECS:
        _close(getattr(st_t, k).numpy(), getattr(st_j, k), 1e-10, k)
    assert int(st_t.inner) == int(st_j.inner)


def test_initial_metrics_and_unscale_match_jax(pair):
    lp_j, scal_j, lam, maps, lp_t, scal_t = pair
    d = _random_state(np.random.default_rng(2), lp_j, maps)
    m_j = jchunk.initial_metrics(lp_j, scal_j, _jax_state(d))
    m_t = tchunk.initial_metrics(lp_t, scal_t, convert.state_from_numpy(d))
    for k in m_j:
        _close(float(m_t[k]), float(m_j[k]), 1e-10, k)
    for a, b in zip(tchunk.unscale_solution(scal_t,
                                            convert.state_from_numpy(d)),
                    jchunk.unscale_solution(scal_j, _jax_state(d))):
        _close(a.numpy(), b, 1e-12, "unscale")


# ---------------------------------------------------------------------------
# Decisions: the style of tests/test_device_loop_oracle.py, with its helpers
# copied here (that module is a test, not a library).
# ---------------------------------------------------------------------------

def random_metrics(rng, decaying_scale, tiny_residuals=False):
    """A plausible chunk-boundary metrics dict (all host floats)."""
    s = decaying_scale
    res_scale = 1e-10 if tiny_residuals else s
    dy2 = float(rng.lognormal(0, 1)) * s * s
    dx2 = float(rng.lognormal(0, 1)) * s * s
    # gap_dot sometimes strongly negative: the lambda self-correction.
    sign = -1.0 if rng.random() < 0.3 else 1.0
    dot = sign * float(rng.lognormal(0, 1)) * s * s * (
        3.0 if sign < 0 else 0.3)
    return {
        "dot_c_xbar": float(rng.normal(0, 1)),
        "dot_yobj_ybar": float(rng.normal(0, 1)),
        "dot_xbar_zbar": float(rng.normal(0, 1)),
        "nrm_Rd": float(rng.lognormal(0, 1)) * res_scale,
        "nrm_Rp": float(rng.lognormal(0, 1)) * res_scale,
        "gap_dot": dot,
        "gap_dy2": dy2,
        "gap_dx2": dx2,
        # move_x sometimes EXACTLY zero (the degenerate-sigma branch).
        "move_x": (0.0 if rng.random() < 0.15
                   else float(rng.lognormal(0, 2)) * s),
        "move_y": float(rng.lognormal(0, 2)) * s,
        "nrm_lu_viol": float(rng.lognormal(0, 1)) * res_scale,
        "fs_dot": dot * 0.5,
        "fs_dy2": dy2 * 0.8,
        "fs_dx2": dx2 * 0.8,
    }


# Jitted once per process: eager JAX dispatch of the decision logic costs
# seconds per test.
_jax_decide = jax.jit(jloop._decide_and_update,
                      static_argnames=("check_iter", "dtype", "use_pair"))
_jax_m_norm = jax.jit(jloop._m_norm_dev)

SCAL_HOST = {"b_scale": 1.37, "c_scale": 0.71, "norm_b_org": 5.3,
             "norm_c_org": 2.9}


def _scal_np():
    d = {k: np.asarray(v) for k, v in SCAL_HOST.items()}
    d.update(row_norm=np.zeros(4), col_norm=np.zeros(4),
             norm_b=np.asarray(1.0), norm_c=np.asarray(1.0))
    return d


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("tiny", [False, True])
def test_decide_and_update_matches_jax(seed, tiny):
    """Both decision functions over 40 chunk boundaries of random metrics:
    flag, sigma, lambda and every RestartDev field at each step.  sigma's
    exp/log chain runs in f32 in both, and XLA's and PyTorch's f32 exp/log
    may differ in the last bit; the merit gaps (a cancelling sum scaled by
    sigma) amplify that, hence the looser tolerances after step 0."""
    rng = np.random.default_rng(seed)
    obj_c = 0.25
    sigma0 = float(rng.lognormal(0, 0.5))
    lam0 = float(rng.lognormal(1, 0.5))
    scal_j = JaxScalingInfo(**{k: jnp.asarray(v)
                               for k, v in _scal_np().items()})
    scal_t = convert.scaling_from_numpy(_scal_np())
    rd_j = jloop.init_restart_dev(sigma0, jnp.float64)
    rd_t = tloop.init_restart_dev(sigma0, F64, "cpu")
    sig_j, lam_j = jnp.asarray(sigma0), jnp.asarray(lam0)
    sig_t, lam_t = torch.tensor(sigma0, dtype=F64), torch.tensor(lam0,
                                                                 dtype=F64)
    obj_t = torch.tensor(obj_c, dtype=F64)
    m_prev = random_metrics(rng, 1.0, tiny)
    it = 0
    for step in range(40):
        rd_j, sig_j, lam_j, flag_j = _jax_decide(
            rd_j, sig_j, lam_j, {k: jnp.asarray(v) for k, v in m_prev.items()},
            scal_j, obj_c, it, check_iter=CHECK, dtype=jnp.float64)
        rd_t, sig_t, lam_t, flag_t = tloop._decide_and_update(
            rd_t, sig_t, lam_t,
            {k: torch.tensor(v, dtype=F64) for k, v in m_prev.items()},
            scal_t, obj_t, it, CHECK, F64)
        assert bool(flag_t) == bool(flag_j), f"step {step}: flag"
        assert float(sig_t) == pytest.approx(float(sig_j), rel=1e-6), step
        assert float(lam_t) == pytest.approx(float(lam_j), rel=1e-6), step

        m_next = random_metrics(rng, math.exp(-0.05 * step), tiny)
        lg_j, lf_j = _jax_m_norm(
            sig_j, lam_j, *(jnp.asarray(m_next[k])
                            for k in ("fs_dot", "fs_dy2", "fs_dx2")))
        lg_t, lf_t = tloop._m_norm_dev(
            sig_t, lam_t, *(torch.tensor(m_next[k], dtype=F64)
                            for k in ("fs_dot", "fs_dy2", "fs_dx2")))
        if bool(flag_j):
            lam_j, lam_t = lf_j, lf_t
            rd_j = dataclasses.replace(rd_j, last_gap=lg_j)
            rd_t = dataclasses.replace(rd_t, last_gap=lg_t)
        rd_j = dataclasses.replace(rd_j, inner=rd_j.inner + CHECK)
        rd_t = dataclasses.replace(rd_t, inner=rd_t.inner + CHECK)
        for k in RD_FLOATS:
            a, b = float(getattr(rd_t, k)), float(getattr(rd_j, k))
            if math.isinf(b):
                assert a == b, f"step {step}: {k}"
            else:
                assert a == pytest.approx(b, rel=1e-4, abs=1e-300), k
        assert bool(rd_t.first_restart) == bool(rd_j.first_restart)
        assert int(rd_t.times) == int(rd_j.times), f"step {step}: times"
        m_prev = m_next
        it += CHECK


@pytest.mark.parametrize("stall_patience", [0, 1])
def test_run_superchunk_matches_jax(pair, stall_patience):
    """Four chunks from the initial point; stall_patience=1 makes the
    recovery fire at the first checkpoint that does not improve 3%.

    Up to the first sigma update the stacked metrics agree to 1e-9.  From
    it on, sigma comes out of the f32 exp/log chain (f32 on purpose in both
    packages), whose XLA and PyTorch results may differ in the last bits,
    and each later sigma and metric inherits that; the test bounds the
    drift at 1e-5.  The stall case runs 6 chunks of 5 iterations, so that
    a checkpoint fails to improve 3% and the recovery fires."""
    lp_j, scal_j, lam, maps, lp_t, scal_t = pair
    n_chunks, check = (6, 5) if stall_patience else (4, CHECK)
    sigma = float(scal_j.norm_b) / float(scal_j.norm_c)
    st_j = jchunk.init_state(lp_j)
    m0_j = jchunk.initial_metrics(lp_j, scal_j, st_j)
    out_j = jloop.run_superchunk(
        lp_j, scal_j, st_j, jloop.init_restart_dev(sigma, jnp.float64),
        jnp.asarray(sigma), jnp.asarray(lam), m0_j, 0, jnp.asarray(0.0),
        1e-12, n_chunks, check, stall_patience, None)
    st_t = tchunk.init_state(lp_t)
    m0_t = tchunk.initial_metrics(lp_t, scal_t, st_t)
    out_t = tloop.run_superchunk(
        lp_t, scal_t, st_t, tloop.init_restart_dev(sigma, F64, "cpu"),
        torch.tensor(sigma, dtype=F64), torch.tensor(lam, dtype=F64), m0_t,
        0, torch.tensor(0.0, dtype=F64), 1e-12, n_chunks, check,
        stall_patience, None)
    state_j, rd_j, stacked_j, k_j = out_j[0], out_j[1], out_j[5], out_j[6]
    state_t, rd_t, stacked_t, k_t = out_t[0], out_t[1], out_t[5], out_t[6]
    assert k_t == int(k_j) == n_chunks
    stacked_j = {k: np.asarray(v, np.float64)[:k_t]
                 for k, v in stacked_j.items()}
    for k in ("flag", "stall"):
        np.testing.assert_array_equal(stacked_t[k], stacked_j[k], err_msg=k)
    if stall_patience:
        assert stacked_t["stall"].sum() > 0  # the recovery path ran
    # Chunk k runs with the sigma decided just before it (stacked sigma[k],
    # flag[k]): the first flagged chunk is the first with a chain sigma.
    first = int(np.argmax(stacked_j["flag"] > 0))
    assert 1 <= first < k_t
    for k in stacked_j:
        _close(stacked_t[k][:first], stacked_j[k][:first], 1e-9, k)
        _close(stacked_t[k], stacked_j[k], 1e-5, k)
    for k in STATE_VECS:
        _close(getattr(state_t, k).numpy(), getattr(state_j, k), 1e-5, k)
    for k in RD_FLOATS:
        a, b = float(getattr(rd_t, k)), float(getattr(rd_j, k))
        assert a == b if math.isinf(b) else a == pytest.approx(b, rel=1e-5)
    for k in ("times", "stalls", "since_best"):
        assert int(getattr(rd_t, k)) == int(getattr(rd_j, k)), k
