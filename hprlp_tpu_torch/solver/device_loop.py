"""Restart/sigma control and stopping over a run of chunks.

Port of hprlp_tpu/solver/device_loop.py.  PyTorch has no traced while loop,
so run_superchunk is a Python loop over chunks.  Every decision (merit norm
with the lambda self-correction, the sufficient/necessary/long restart
conditions, sigma re-estimation, stall recovery, the Halpern counter) stays
a torch op on 0-dim device tensors in the solve dtype, as in JAX; only the
iteration count `it` is a host int.  Each chunk ends with ONE host read of
a small stacked tensor (the metrics, sigma, flags, KKT and the stop test),
and the loop stops at the first checkpoint whose KKT error is below
stop_tol, so the returned state is that checkpoint's state.

Semantics mirror the JAX package exactly (same conditions, same ordering:
decide from the PREVIOUS chunk's metrics, then iterate).  The TPU-only
pair-arithmetic merit norm (_m_norm_dev_pair) has no counterpart: the GPU's
f64 is native.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .chunk import run_chunk

METRIC_KEYS = ("dot_c_xbar", "dot_yobj_ybar", "dot_xbar_zbar", "nrm_Rd",
               "nrm_Rp", "gap_dot", "gap_dy2", "gap_dx2", "move_x",
               "move_y", "nrm_lu_viol", "fs_dot", "fs_dy2", "fs_dx2")
# Per-chunk host record: the metrics, then these.
STACK_KEYS = METRIC_KEYS + ("sigma", "flag", "stall", "kkt", "done")


@dataclasses.dataclass(frozen=True)
class RestartDev:
    """Device mirror of the reference's HPRLP_restart (include/structs.h:
    215-228) plus the stall-recovery tracker (see run_superchunk)."""

    first_restart: torch.Tensor  # bool
    last_gap: torch.Tensor
    current_gap: torch.Tensor
    save_gap: torch.Tensor
    best_gap: torch.Tensor
    best_sigma: torch.Tensor
    inner: torch.Tensor          # float (compared against 0.2 * it)
    times: torch.Tensor          # int32 restart count
    best_kkt: torch.Tensor       # float
    since_best: torch.Tensor     # int32 checkpoints
    stalls: torch.Tensor         # int32 interventions


def init_restart_dev(sigma, dtype, device) -> RestartDev:
    def f(v):
        return torch.tensor(v, dtype=dtype, device=device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    inf = float("inf")
    return RestartDev(
        first_restart=torch.tensor(True, device=device),
        last_gap=f(inf), current_gap=f(inf), save_gap=f(inf), best_gap=f(inf),
        best_sigma=f(float(sigma)), inner=f(0.0), times=i32(0),
        best_kkt=f(inf), since_best=i32(0), stalls=i32(0))


def _m_norm_dev(sigma, lam, dot, dy2, dx2):
    """M-norm merit with the lambda_max negative-norm self-correction
    (reference: src/main_iterate.cu:486-515).  The 1e-300 floor underflows
    to 0 in f32, as in JAX."""
    dot2 = 2.0 * dot
    w = sigma * lam * dy2 + dx2 / sigma + dot2
    neg = w < 0
    lam_fix = torch.where(neg & (sigma * dy2 > 0),
                          -(dot2 + dx2 / sigma)
                          / torch.clamp(sigma * dy2, min=1e-300) * 1.05, lam)
    norm = torch.where(
        neg, torch.sqrt(torch.clamp(-(dot2 + dx2 / sigma) * 0.05, min=0.0)),
        torch.sqrt(torch.clamp(w, min=0.0)))
    return norm, lam_fix


def _residuals_core(m, b_scale, c_scale, norm_b_org, norm_c_org,
                    obj_constant, is_iter0: bool):
    """Original-space KKT residual pieces."""
    obj_scale = b_scale * c_scale
    p_obj = obj_scale * m["dot_c_xbar"] + obj_constant
    d_obj = obj_scale * (m["dot_yobj_ybar"] + m["dot_xbar_zbar"]) + obj_constant
    rel_gap = (p_obj - d_obj).abs() / (1.0 + p_obj.abs() + d_obj.abs())
    err_Rd = c_scale * m["nrm_Rd"] / norm_c_org
    err_Rp = b_scale * m["nrm_Rp"] / norm_b_org
    if is_iter0:
        err_Rp = torch.maximum(err_Rp, b_scale * m["nrm_lu_viol"])
    return err_Rp, err_Rd, rel_gap


def _residuals_dev(m, scal, obj_constant, is_iter0: bool):
    return _residuals_core(m, scal.b_scale, scal.c_scale, scal.norm_b_org,
                           scal.norm_c_org, obj_constant, is_iter0)


def _sigma_chain(m_prev, lam, current_gap, best_gap, best_sigma, err_Rp,
                 err_Rd, rel_gap, sigma, flag, dtype):
    """update_sigma (reference :367-404).

    The exp/log chain runs in f32 on purpose, as in the JAX package:
    sigma is a step-size heuristic and f32 accuracy is ample.
    """
    f32 = torch.float32
    pm, dm = m_prev["move_x"], m_prev["move_y"]
    ok = (pm > 1e-16) & (dm > 1e-16) & (pm < 1e12) & (dm < 1e12)
    ratio = ((pm / torch.clamp(dm, min=1e-300)) / torch.sqrt(lam)).to(f32)
    fact = torch.exp((-0.05 * (current_gap
                               / torch.clamp(best_gap, min=1e-300))).to(f32))
    temp1 = torch.maximum(torch.minimum(err_Rd, err_Rp),
                          torch.minimum(rel_gap, current_gap))
    sigma_cand = torch.exp(
        fact * torch.log(torch.clamp(ratio, min=1e-30))
        + (1 - fact) * torch.log(torch.clamp(best_sigma.to(f32), min=1e-30)))
    ratio_inf = torch.where(err_Rp > 0,
                            err_Rd / torch.clamp(err_Rp, min=1e-300),
                            1.0).to(f32)
    kappa = torch.where(
        temp1 > 9e-10, torch.ones((), dtype=f32, device=sigma.device),
        torch.where(temp1 > 5e-10,
                    torch.clamp(torch.sqrt(ratio_inf), 1e-2, 100.0),
                    torch.clamp(ratio_inf, 1e-2, 100.0)))
    # Degenerate movement keeps best_sigma (the reference resets 1.0,
    # which destroys the adapted sigma of a vertex-pinned f32 iterate).
    return torch.where(flag,
                       torch.where(ok, (kappa * sigma_cand).to(dtype),
                                   best_sigma.to(dtype)),
                       sigma)


def _decide_and_update(rd: RestartDev, sigma, lam, m_prev, scal,
                       obj_constant, it: int, check_iter: int, dtype):
    """check_restart + update_sigma (reference main_iterate.cu:324-404),
    branch-free on the device; `it` is the host iteration count."""
    err_Rp, err_Rd, rel_gap = _residuals_dev(m_prev, scal, obj_constant,
                                             it == 0)
    if it > 0:
        cg, lam = _m_norm_dev(sigma, lam, m_prev["gap_dot"],
                              m_prev["gap_dy2"], m_prev["gap_dx2"])
    else:
        cg = rd.current_gap

    # First restart (">=": the boundary may have been coarsened).
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

    sigma_new = _sigma_chain(m_prev, lam, current_gap, best_gap, best_sigma,
                             err_Rp, err_Rd, rel_gap, sigma, flag, dtype)

    rd_new = dataclasses.replace(
        rd,
        first_restart=rd.first_restart & ~fr,
        current_gap=current_gap,
        save_gap=torch.where(flag, float("inf"), save_gap),
        best_gap=best_gap,
        best_sigma=best_sigma,
        inner=torch.where(flag, 0.0, rd.inner),
        times=rd.times + flag.to(torch.int32))
    return rd_new, sigma_new, lam, flag


def run_superchunk(lp, scal, state, rd: RestartDev, sigma, lambda_max,
                   metrics_prev, it0: int, obj_constant, stop_tol: float,
                   n_chunks: int, check_iter: int, stall_patience: int = 0,
                   best=None):
    """Advance up to n_chunks * check_iter iterations with restarts on the
    device and stopping at the first chunk boundary whose relative KKT
    error is below stop_tol.

    stall_patience (0 = off): STALL RECOVERY, as in the JAX package.  When
    the best KKT error has not improved by >=3% for `stall_patience`
    consecutive checkpoints, restore the bars to the best-KKT boundary and
    force a restart from them with the sigma recorded there scaled by the
    bounded ladder 4^0, 4^-1, 4^+1, 4^-2, 4^+2 (repeating).  Dormant on
    converging solves: any 3% improvement re-arms the counter.

    best: the best-point dict returned by the previous call (None
    initialises it from `state`).  metrics_prev: the metrics of the
    previous boundary (initial_metrics at it0 == 0).

    Returns (state, rd, sigma, lambda_max, m_last, stacked, k_done, best):
    stacked maps each of STACK_KEYS to a float64 numpy array of the k_done
    chunks run.
    """
    dtype, device = lp.c.dtype, lp.c.device
    stop_tol_dev = torch.tensor(stop_tol, dtype=dtype, device=device)
    if best is None:
        best = {"x_bar": state.x_bar, "y_bar": state.y_bar, "sigma": sigma}
    no_stall = torch.tensor(False, device=device)
    lam = lambda_max
    m = metrics_prev
    it = it0
    rows = []
    for _ in range(n_chunks):
        rd, sigma, lam, flag = _decide_and_update(
            rd, sigma, lam, m, scal, obj_constant, it, check_iter, dtype)
        # Stall recovery, applied after the normal decision so that the
        # decision logic is untouched while it is dormant.
        stall = (rd.since_best >= stall_patience if stall_patience > 0
                 else no_stall)
        j = rd.stalls % 5
        rung = ((j + 1) // 2) * (1 - 2 * (j % 2))  # 0,-1,+1,-2,+2
        sigma_rec = best["sigma"] * torch.exp2(
            (2 * rung).to(torch.float32)).to(dtype)
        sigma = torch.where(stall, sigma_rec, sigma)
        state = dataclasses.replace(
            state,
            x_bar=torch.where(stall, best["x_bar"], state.x_bar),
            y_bar=torch.where(stall, best["y_bar"], state.y_bar))
        rd = dataclasses.replace(
            rd,
            save_gap=torch.where(stall, float("inf"), rd.save_gap),
            inner=torch.where(stall, 0.0, rd.inner),
            times=rd.times + (stall & ~flag).to(torch.int32),
            stalls=rd.stalls + stall.to(torch.int32),
            since_best=torch.where(stall, 0, rd.since_best))
        flag = flag | stall
        state, m = run_chunk(lp, scal, state, sigma, lam, flag, check_iter)
        lg, lam_fix = _m_norm_dev(sigma, lam, m["fs_dot"], m["fs_dy2"],
                                  m["fs_dx2"])
        lam = torch.where(flag, lam_fix, lam)
        rd = dataclasses.replace(rd,
                                 last_gap=torch.where(flag, lg, rd.last_gap),
                                 inner=rd.inner + check_iter)
        it += check_iter
        # Stopping on the NEW boundary's relative KKT error (the formula
        # the host uses) and the stall tracker: a >=3% improvement re-arms
        # the patience counter, any improvement refreshes the best point.
        err_Rp, err_Rd, rel_gap = _residuals_dev(m, scal, obj_constant,
                                                 False)
        kkt = torch.maximum(torch.maximum(err_Rp, err_Rd), rel_gap)
        improved = kkt < 0.97 * rd.best_kkt
        better = kkt < rd.best_kkt
        best = {
            "x_bar": torch.where(better, state.x_bar, best["x_bar"]),
            "y_bar": torch.where(better, state.y_bar, best["y_bar"]),
            "sigma": torch.where(better, sigma, best["sigma"]),
        }
        rd = dataclasses.replace(
            rd, best_kkt=torch.minimum(rd.best_kkt, kkt),
            since_best=torch.where(improved, 0, rd.since_best + 1))
        done = kkt < stop_tol_dev
        row = torch.stack([m[k].to(dtype) for k in METRIC_KEYS]
                          + [sigma, flag.to(dtype), stall.to(dtype), kkt,
                             done.to(dtype)])
        rows.append(row.cpu().numpy().astype(np.float64))  # one host read
        if rows[-1][-1]:
            break
    table = np.stack(rows)
    stacked = {k: table[:, i] for i, k in enumerate(STACK_KEYS)}
    return state, rd, sigma, lam, m, stacked, len(rows), best
