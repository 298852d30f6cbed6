"""The chunk boundary as one step on static buffers (solver/device_loop.py::
ChunkStep, solver/batched_device_loop.py::BatchedChunkStep), which the card
captures in a CUDA graph and the CPU runs eagerly (CPU, f64).

The step tests the iteration count on the device.  It is held bitwise to
the previous design, which tested a host int: `_decide_host` and
`_boundary_host` below are that design's decision and chunk boundary,
kept here as the reference.  After the first converged boundary, further
steps must leave every buffer as it was (the graph's replays may run one
chunk past it).  The card's side (capture, replay, launch counts) is in
tests/test_torch_graph_gpu.py."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hprlp_tpu_torch.ops.device_problem import (attach_tiles,
                                                build_device_problem)
from hprlp_tpu_torch.ops.tiles import build_tiles
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.solver import batched as tb
from hprlp_tpu_torch.solver import batched_device_loop as tbl
from hprlp_tpu_torch.solver import device_loop as tloop
from hprlp_tpu_torch.solver.chunk import (SolverState, init_state,
                                          initial_metrics, run_chunk)
from hprlp_tpu_torch.solver.graph import time_probe
from hprlp_tpu_torch.solver.power_iteration import power_method
from hprlp_tpu_torch.solver.scaling import scale_problem

torch.set_num_threads(1)

F64 = torch.float64
CPU = torch.device("cpu")


def _lp(seed=0, m=40, n=60):
    """A random feasible LP set up as solve_problem sets it up: layout,
    tiles, scaling, lambda_max and sigma."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.3, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x
    prob = LpProblem.from_arrays(A, Ax - rng.uniform(0.1, 2.0, m),
                                 Ax + rng.uniform(0.1, 2.0, m),
                                 x - rng.uniform(0.1, 3.0, n),
                                 x + rng.uniform(0.1, 3.0, n),
                                 rng.normal(size=n))
    raw, _ = build_device_problem(prob, dtype=F64, device="cpu")
    tiles = (build_tiles(raw.A), build_tiles(raw.AT))
    lp, scal = scale_problem(raw)
    lp = attach_tiles(lp, *tiles)
    lam = max(float(power_method(lp)) * 1.01, 1e-12)
    nb, nc = float(scal.norm_b), float(scal.norm_c)
    sigma = nb / nc if nb > 1e-8 and nc > 1e-8 else 1.0
    return lp, scal, sigma, lam


# ---------------------------------------------------------------------------
# The previous design: `it` a host int (the reference of the bitwise tests)
# ---------------------------------------------------------------------------

def _decide_host(rd, sigma, lam, m_prev, scal, obj_constant, it: int,
                 check_iter: int, dtype):
    err_Rp, err_Rd, rel_gap = tloop._residuals_dev(m_prev, scal,
                                                   obj_constant, it == 0)
    if it > 0:
        cg, lam = tloop._m_norm_dev(sigma, lam, m_prev["gap_dot"],
                                    m_prev["gap_dy2"], m_prev["gap_dx2"])
    else:
        cg = rd.current_gap
    fr = rd.first_restart & (it >= check_iter)
    est = ~rd.first_restart
    cg_est = torch.where(cg < 0, 1e-6, cg)
    sufficient = est & (cg_est <= 0.2 * rd.last_gap)
    necessary = est & (cg_est <= 0.6 * rd.last_gap) & (cg_est > rd.save_gap)
    long_r = est & (rd.inner >= 0.2 * it)
    flag = fr | sufficient | necessary | long_r
    better = est & (rd.best_gap > cg_est)
    best_gap = torch.where(fr, cg, torch.where(better, cg_est, rd.best_gap))
    best_sigma = torch.where(fr | better, sigma, rd.best_sigma)
    save_gap = torch.where(est, cg_est, rd.save_gap)
    current_gap = torch.where(est, cg_est, cg)
    sigma_new = tloop._sigma_chain(m_prev, lam, current_gap, best_gap,
                                   best_sigma, err_Rp, err_Rd, rel_gap,
                                   sigma, flag, dtype)
    rd_new = dataclasses.replace(
        rd, first_restart=rd.first_restart & ~fr, current_gap=current_gap,
        save_gap=torch.where(flag, float("inf"), save_gap),
        best_gap=best_gap, best_sigma=best_sigma,
        inner=torch.where(flag, 0.0, rd.inner),
        times=rd.times + flag.to(torch.int32))
    return rd_new, sigma_new, lam, flag


def _boundary_host(lp, scal, state, rd, sigma, lam, m, it: int, obj_c,
                   check: int, patience: int, best):
    """One chunk boundary of the previous run_superchunk loop.  Returns
    (state, rd, sigma, lam, m, best, row)."""
    dtype = lp.c.dtype
    rd, sigma, lam, flag = _decide_host(rd, sigma, lam, m, scal, obj_c, it,
                                        check, dtype)
    stall = (rd.since_best >= patience if patience > 0
             else torch.tensor(False))
    j = rd.stalls % 5
    rung = ((j + 1) // 2) * (1 - 2 * (j % 2))
    sigma_rec = best["sigma"] * torch.exp2(
        (2 * rung).to(torch.float32)).to(dtype)
    sigma = torch.where(stall, sigma_rec, sigma)
    state = dataclasses.replace(
        state, x_bar=torch.where(stall, best["x_bar"], state.x_bar),
        y_bar=torch.where(stall, best["y_bar"], state.y_bar))
    rd = dataclasses.replace(
        rd, save_gap=torch.where(stall, float("inf"), rd.save_gap),
        inner=torch.where(stall, 0.0, rd.inner),
        times=rd.times + (stall & ~flag).to(torch.int32),
        stalls=rd.stalls + stall.to(torch.int32),
        since_best=torch.where(stall, 0, rd.since_best))
    flag = flag | stall
    state, m = run_chunk(lp, scal, state, sigma, lam, flag, check)
    lg, lam_fix = tloop._m_norm_dev(sigma, lam, m["fs_dot"], m["fs_dy2"],
                                    m["fs_dx2"])
    lam = torch.where(flag, lam_fix, lam)
    rd = dataclasses.replace(rd, last_gap=torch.where(flag, lg, rd.last_gap),
                             inner=rd.inner + check)
    err_Rp, err_Rd, rel_gap = tloop._residuals_dev(m, scal, obj_c, False)
    kkt = torch.maximum(torch.maximum(err_Rp, err_Rd), rel_gap)
    improved = kkt < 0.97 * rd.best_kkt
    better = kkt < rd.best_kkt
    best = {"x_bar": torch.where(better, state.x_bar, best["x_bar"]),
            "y_bar": torch.where(better, state.y_bar, best["y_bar"]),
            "sigma": torch.where(better, sigma, best["sigma"])}
    rd = dataclasses.replace(
        rd, best_kkt=torch.minimum(rd.best_kkt, kkt),
        since_best=torch.where(improved, 0, rd.since_best + 1))
    done = kkt < 1e-12
    row = torch.stack([m[k].to(dtype) for k in tloop.METRIC_KEYS]
                      + [sigma, flag.to(dtype), stall.to(dtype), kkt,
                         done.to(dtype)])
    return state, rd, sigma, lam, m, best, row


def _equal_fields(a, b, what):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
            f"{what}.{f.name}"


# ---------------------------------------------------------------------------
# Single LP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,patience", [(0, 1), (2, 1), (1, 0)])
def test_step_matches_the_host_int_path(seed, patience):
    """Ten boundaries of 5 iterations from it = 0: flag, sigma, lambda,
    every RestartDev and state field, the metrics, the best point and the
    stacked row bitwise equal to the host-int design's, boundary by
    boundary.  The sequence holds it == 0, restarts, and (patience 1)
    stall recoveries."""
    lp, scal, sigma0, lam0 = _lp(seed)
    check, obj_c = 5, torch.tensor(0.25, dtype=F64)
    state = init_state(lp)
    rd = tloop.init_restart_dev(sigma0, F64, CPU)
    sigma, lam = torch.tensor(sigma0, dtype=F64), torch.tensor(lam0,
                                                                dtype=F64)
    m = initial_metrics(lp, scal, state)
    best = {"x_bar": state.x_bar, "y_bar": state.y_bar, "sigma": sigma}
    step = tloop.ChunkStep(lp, scal, state, rd, sigma, lam, m, obj_c, 1e-12,
                           check, patience)
    flags, stalls = [], []
    for k in range(10):
        state, rd, sigma, lam, m, best, row = _boundary_host(
            lp, scal, state, rd, sigma, lam, m, k * check, obj_c, check,
            patience, best)
        step.step()
        _equal_fields(step.state, state, f"boundary {k}: state")
        _equal_fields(step.rd, rd, f"boundary {k}: rd")
        assert torch.equal(step.sigma, sigma) and torch.equal(step.lam, lam)
        for key in m:
            assert torch.equal(step.m[key], m[key]), (k, key)
        for key in best:
            assert torch.equal(step.best[key], best[key]), (k, key)
        assert torch.equal(step.row, row), k
        assert int(step.it) == (k + 1) * check
        flags.append(float(row[-4]))
        stalls.append(float(row[-3]))
    assert sum(flags) > 0
    if patience:
        assert sum(stalls) > 0


def test_decide_takes_a_device_it_and_a_host_it_alike():
    """_decide_and_update at it = 0, check and 7 * check, with the count as
    a host int and as a 0-dim int64 tensor: bitwise the host-int design's
    lambda, sigma, flag and restart state (lambda's self-correction is not
    applied at it = 0, where the merit norm is computed and discarded)."""
    lp, scal, sigma0, lam0 = _lp(3)
    state = init_state(lp)
    state, m = run_chunk(lp, scal, state, torch.tensor(sigma0, dtype=F64),
                         torch.tensor(lam0, dtype=F64), torch.tensor(False),
                         7)
    m = dict(m, gap_dot=-abs(m["gap_dot"]) * 1e6)  # a negative merit
    rd = tloop.init_restart_dev(sigma0, F64, CPU)
    rd = dataclasses.replace(
        rd, first_restart=torch.tensor(False),
        **{k: torch.tensor(v, dtype=F64) for k, v in (
            ("last_gap", 1.0), ("current_gap", 0.5), ("save_gap", 0.45),
            ("best_gap", 0.4), ("inner", 30.0))})
    sigma, lam = torch.tensor(sigma0, dtype=F64), torch.tensor(lam0,
                                                                dtype=F64)
    obj_c = torch.tensor(0.0, dtype=F64)
    for it in (0, 150, 1050):
        ref = _decide_host(rd, sigma, lam, m, scal, obj_c, it, 150, F64)
        for it_arg in (it, torch.tensor(it, dtype=torch.int64)):
            got = tloop._decide_and_update(rd, sigma, lam, m, scal, obj_c,
                                           it_arg, 150, F64)
            _equal_fields(got[0], ref[0], f"it={it}: rd")
            for a, b in zip(got[1:], ref[1:]):
                assert torch.equal(a, b), it
    assert float(ref[2]) != lam0  # the self-correction ran at it > 0


def _snapshot(step):
    bufs = {f"state.{f.name}": getattr(step.state, f.name)
            for f in dataclasses.fields(step.state)}
    bufs.update({f"rd.{f.name}": getattr(step.rd, f.name)
                 for f in dataclasses.fields(step.rd)})
    bufs.update({f"m.{k}": v for k, v in step.m.items()})
    for name in ("sigma", "lam", "it", "row", "best", "active"):
        v = getattr(step, name, None)
        if isinstance(v, dict):
            bufs.update({f"{name}.{k}": t for k, t in v.items()})
        elif v is not None:
            bufs[name] = v
    return {k: v.clone() for k, v in bufs.items()}


@pytest.mark.parametrize("done_at", [1, 3])
def test_steps_past_done_leave_every_buffer(done_at):
    """A stop_tol between the KKT errors of boundaries done_at - 1 and
    done_at: the step reports done there, and two more steps leave the
    state, restart state, sigma, lambda, metrics, best point, count and
    row bitwise as they were.  run_superchunk stops at the same boundary."""
    lp, scal, sigma0, lam0 = _lp(4)
    check, obj_c = 5, torch.tensor(0.0, dtype=F64)
    state = init_state(lp)
    args = (lp, scal, state, tloop.init_restart_dev(sigma0, F64, CPU),
            torch.tensor(sigma0, dtype=F64), torch.tensor(lam0, dtype=F64),
            initial_metrics(lp, scal, state), obj_c)
    probe = tloop.ChunkStep(*args, 0.0, check, 1)
    kkts = []
    for _ in range(done_at):
        probe.step()
        kkts.append(float(probe.row[tloop.STACK_KEYS.index("kkt")]))
    assert min(kkts[:-1], default=np.inf) > kkts[-1]
    stop_tol = kkts[-1] * (1 + 1e-9)
    step = tloop.ChunkStep(*args, stop_tol, check, 1)
    for k in range(done_at):
        step.step()
        assert bool(step.done) == (k == done_at - 1)
    before = _snapshot(step)
    for _ in range(2):
        step.step()
    after = _snapshot(step)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    out = tloop.run_superchunk(*args[:7], 0, obj_c, stop_tol, 8, check, 1)
    assert out[6] == done_at
    assert out[5]["done"].tolist() == [0.0] * (done_at - 1) + [1.0]
    for f in dataclasses.fields(SolverState):
        assert torch.equal(getattr(out[0], f.name),
                           before[f"state.{f.name}"]), f.name


def test_the_card_never_takes_the_eager_route_unasked():
    """graph=None off the CPU raises (the solve passes its graph); the
    check comes before any work, so a stand-in LP on the meta device
    shows it."""
    lp = types.SimpleNamespace(c=torch.empty(1, device="meta"))
    with pytest.raises(ValueError, match="graph=False"):
        tloop.run_superchunk(lp, None, None, None, None, None, None, 0,
                             None, 1e-4, 1, 150)
    with pytest.raises(ValueError, match="graph=False"):
        tbl.run_batched_superchunk(lp, None, None, None, None, None, None,
                                   None, None, 0, None, None, None, None,
                                   None, 1e-4, 1, 150)


def test_time_probe_on_the_cpu_times_eager_calls():
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(3)

    secs, out = time_probe(fn, CPU, reps=2)
    assert secs >= 0.0 and torch.equal(out, torch.ones(3))
    assert len(calls) == 3  # one to warm up, then the timed ones


# ---------------------------------------------------------------------------
# Batched
# ---------------------------------------------------------------------------

B = 4


def _batched(seed=5, m=30, n=50):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.3, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x = rng.uniform(-1.0, 1.0, (n, B))
    Ax = A @ x
    C = rng.normal(size=(n, B))
    params = tb.Parameters()
    su = tb.setup_batched(A, C, Ax - 1.0, Ax + 1.0, x - 2.0, x + 2.0,
                          params, CPU, F64)
    lam = max(float(power_method(su.lp0)) * 1.01, 1e-12)
    sigma = torch.as_tensor(tb.initial_sigma(su), dtype=F64)
    state = tb.init_batched_state(su.lp)
    scales = tuple(torch.as_tensor(v, dtype=F64) for v in (
        su.b_scale, su.c_scale, su.norm_b_org, su.norm_c_org, np.zeros(B)))
    m0 = tb.initial_bmetrics(su.lp, su.row_norm, su.col_norm, state)
    rd = tbl.init_batched_restart_dev(sigma, F64)
    return (su.lp, su.row_norm, su.col_norm, state, rd, sigma,
            torch.full((B,), lam, dtype=F64)), m0, scales


def _bdecide_host(rd, sigma, lam, active, m_prev, b_scale, c_scale,
                  norm_b_org, norm_c_org, obj_constants, it: int,
                  check_iter: int, dtype):
    """The previous design's _bdecide: `it` a host int."""
    err_Rp, err_Rd, rel_gap = tloop._residuals_core(
        m_prev, b_scale, c_scale, norm_b_org, norm_c_org, obj_constants,
        it == 0)
    if it > 0:
        cg, lam = tloop._m_norm_dev(sigma, lam, m_prev["gap_dot"],
                                    m_prev["gap_dy2"], m_prev["gap_dx2"])
    else:
        cg = rd.current_gap
    fr = rd.first_restart & active & (it >= check_iter)
    est = ~rd.first_restart & active
    cg_est = torch.where(cg < 0, 1e-6, cg)
    sufficient = est & (cg_est <= 0.2 * rd.last_gap)
    necessary = est & (cg_est <= 0.6 * rd.last_gap) & (cg_est > rd.save_gap)
    long_r = est & (rd.inner >= 0.2 * it)
    flag = fr | sufficient | necessary | long_r
    better = est & (rd.best_gap > cg_est)
    best_gap = torch.where(fr, cg, torch.where(better, cg_est, rd.best_gap))
    best_sigma = torch.where(fr | better, sigma, rd.best_sigma)
    save_gap = torch.where(est, cg_est, rd.save_gap)
    current_gap = torch.where(est, cg_est, cg)
    sigma_new = tloop._sigma_chain(m_prev, lam, current_gap, best_gap,
                                   best_sigma, err_Rp, err_Rd, rel_gap,
                                   sigma, flag, dtype)
    clear_fr = fr.any()
    rd_new = tbl.BatchedRestartDev(
        first_restart=rd.first_restart & ~clear_fr, last_gap=rd.last_gap,
        current_gap=current_gap,
        save_gap=torch.where(flag, float("inf"), save_gap),
        best_gap=best_gap, best_sigma=best_sigma,
        inner=torch.where(flag, 0.0, rd.inner),
        times=rd.times + flag.to(torch.int32))
    return rd_new, sigma_new, lam, flag


def _bboundary_host(lp, rn, cn, state, rd, sigma, lam, active, m, it: int,
                    scales, stop_tol, check):
    """One chunk boundary of the previous run_batched_superchunk loop.
    Returns (state, rd, sigma, lam, active, m, row)."""
    dtype = lp.c.dtype
    rd, sigma, lam, flag = _bdecide_host(rd, sigma, lam, active, m, *scales,
                                         it, check, dtype)
    state, m = tb.run_batched_chunk(lp, rn, cn, state, sigma, lam, flag,
                                    active, check)
    lg, lam_fix = tloop._m_norm_dev(sigma, lam, m["fs_dot"], m["fs_dy2"],
                                    m["fs_dx2"])
    lam = torch.where(flag, lam_fix, lam)
    rd = dataclasses.replace(
        rd, last_gap=torch.where(flag, lg, rd.last_gap),
        inner=rd.inner + torch.where(active, float(check), 0.0))
    err_Rp, err_Rd, rel_gap = tloop._residuals_core(m, *scales, False)
    kkt = torch.maximum(torch.maximum(err_Rp, err_Rd), rel_gap)
    was_active = active
    active = active & (kkt >= torch.tensor(stop_tol, dtype=dtype))
    row = torch.stack([m[k].to(dtype) for k in tloop.METRIC_KEYS]
                      + [sigma, flag.to(dtype), was_active.to(dtype),
                         active.to(dtype)])
    return state, rd, sigma, lam, active, m, row


def test_batched_step_matches_the_host_int_loop():
    """Six boundaries of 5 iterations from it = 0, member 1 frozen from
    the start: the step's buffers and rows bitwise equal to the previous
    loop's (host-int `it`), boundary by boundary; member 1 never moves."""
    (lp, rn, cn, state, rd, sigma, lam), m, scales = _batched()
    active = torch.tensor([True, False, True, True])
    step = tbl.BatchedChunkStep(lp, rn, cn, state, rd, sigma, lam, active,
                                m, *scales, 1e-12, 5)
    flags = 0.0
    for k in range(6):
        state, rd, sigma, lam, active, m, row = _bboundary_host(
            lp, rn, cn, state, rd, sigma, lam, active, m, k * 5, scales,
            1e-12, 5)
        step.step()
        _equal_fields(step.state, state, f"boundary {k}: state")
        _equal_fields(step.rd, rd, f"boundary {k}: rd")
        assert torch.equal(step.sigma, sigma) and torch.equal(step.lam, lam)
        assert torch.equal(step.active, active)
        for key in m:
            assert torch.equal(step.m[key], m[key]), (k, key)
        assert torch.equal(step.row, row), k
        flags += float(row[tbl.STACK_KEYS.index("flag")].sum())
    assert flags > 0
    assert torch.equal(step.state.x[:, 1], torch.zeros_like(
        step.state.x[:, 1]))


def test_batched_steps_with_no_member_active_leave_every_buffer():
    """A stop_tol every member meets at the first boundary: its row marks
    them all inactive, and two more steps leave every buffer (members
    frozen) bitwise as it was.  run_batched_superchunk stops there."""
    (lp, rn, cn, state, rd, sigma, lam), m, scales = _batched(6)
    active = torch.ones(B, dtype=torch.bool)
    step = tbl.BatchedChunkStep(lp, rn, cn, state, rd, sigma, lam, active,
                                m, *scales, 1e30, 5)
    step.step()
    assert not step.active.any()
    assert not step.row[-1].any() and step.row[-2].all()
    before = _snapshot(step)
    for _ in range(2):
        step.step()
    after = _snapshot(step)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    out = tbl.run_batched_superchunk(lp, rn, cn, state, rd, sigma, lam,
                                     active, m, 0, *scales, 1e30, 4, 5)
    assert out[7] == 1
