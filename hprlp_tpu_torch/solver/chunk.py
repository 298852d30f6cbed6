"""The hot path: Halpern Peaceman-Rachford iteration chunks.

Port of hprlp_tpu/solver/chunk.py (plain branch of run_chunk).  PyTorch runs
eagerly, so a chunk is a Python loop of tensor ops; nothing in it reads the
device from the host.  Scalars (sigma, lambda, the Halpern counter, the
restart flag) are 0-dim tensors on the device.

One HPR iteration (reference: src/cuda_kernels/HPR_cuda_kernels.cu:229-295):
    x/z half:  ATy   = A^T y
               z_tmp = x + sigma (ATy - c)
               x_bar = clip(z_tmp, l, u)          [z_bar = (x_bar - z_tmp)/sigma]
               x_hat = 2 x_bar - x
               x     = fact2 x_hat + fact1 last_x
    y half:    Ax    = A x_hat
               v     = Ax - lambda*sigma*y
               d     = max(AL - v, min(AU - v, 0))
               y_bar = d / (lambda*sigma)         [y_obj = v + d]
               y_hat = 2 y_bar - y
               y     = fact2 y_hat + fact1 last_y
    fact1 = 1/(k+2), fact2 = 1 - fact1, k = iterations since restart.

The TPU package's double-f32 chunk (_df64_chunk_iters) has no counterpart:
the GPU has native f64.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.device_problem import LpDevice
from ..ops.sparse import spmv
from .scaling import ScalingInfo


@dataclasses.dataclass(frozen=True)
class SolverState:
    """Device iterate state (parity: HPRLP_workspace_gpu vector fields,
    include/structs.h:127-152)."""

    x: torch.Tensor  # (n,)
    y: torch.Tensor  # (m,)
    last_x: torch.Tensor  # Halpern anchor (point at last restart)
    last_y: torch.Tensor
    # Candidate solution from the last check step (PR midpoints).
    x_bar: torch.Tensor
    y_bar: torch.Tensor
    z_bar: torch.Tensor
    y_obj: torch.Tensor  # v + d: dual-objective support vector
    inner: torch.Tensor  # 0-dim int32: iterations since last restart


def init_state(lp: LpDevice) -> SolverState:
    zn = torch.zeros_like(lp.c)
    zm = torch.zeros_like(lp.AL)
    return SolverState(x=zn, y=zm, last_x=zn, last_y=zm, x_bar=zn, y_bar=zm,
                       z_bar=zn, y_obj=zm,
                       inner=torch.zeros((), dtype=torch.int32,
                                         device=lp.c.device))


def _halpern_factors(inner, dtype):
    fact1 = 1.0 / (inner.to(dtype) + 2.0)
    return fact1, 1.0 - fact1


def _x_half(lp, x, y, last_x, sigma, fact1, fact2):
    ATy = spmv(lp.AT, y)
    z_tmp = x + sigma * (ATy - lp.c)
    x_bar = torch.clamp(z_tmp, lp.l, lp.u)
    x_hat = 2.0 * x_bar - x
    x_new = fact2 * x_hat + fact1 * last_x
    return x_new, x_hat, x_bar, z_tmp


def _y_half(lp, y, x_hat, last_y, lam_sigma, fact1, fact2):
    Ax = spmv(lp.A, x_hat)
    v = Ax - lam_sigma * y
    d = torch.maximum(lp.AL - v, torch.clamp(lp.AU - v, max=0.0))
    y_bar = d / lam_sigma
    y_hat = 2.0 * y_bar - y
    y_new = fact2 * y_hat + fact1 * last_y
    return y_new, y_bar, v + d


def _fixed_point_gap_parts(lp, dx, dy):
    """Components of the M-weighted fixed-point residual
    sigma*lambda*||dy||^2 + ||dx||^2/sigma + 2<A dx, dy>  (reference:
    src/main_iterate.cu:486-515), returned raw so the decision logic can
    apply the lambda_max negative-norm self-correction."""
    A_dx = spmv(lp.A, dx)
    return torch.dot(A_dx, dy), torch.dot(dy, dy), torch.dot(dx, dx)


def _residual_metrics(lp: LpDevice, scal: ScalingInfo, x_bar, y_bar, z_bar,
                      y_obj, dx, dy, last_x, last_y):
    """Original-space KKT residual ingredients (reference:
    src/main_iterate.cu:229-309)."""
    Ax_bar = spmv(lp.A, x_bar)
    Rp = torch.maximum(lp.AL - Ax_bar,
                       torch.clamp(lp.AU - Ax_bar, max=0.0)) * scal.row_norm
    ATy_bar = spmv(lp.AT, y_bar)
    Rd = (lp.c - ATy_bar - z_bar) * scal.col_norm
    gap_dot, gap_dy2, gap_dx2 = _fixed_point_gap_parts(lp, dx, dy)
    # Bound violation of x_bar in original space (used at iteration 0 only,
    # reference: main_iterate.cu:264-289).
    viol = torch.where(x_bar < lp.l, lp.l - x_bar,
                       torch.where(x_bar > lp.u, x_bar - lp.u, 0.0))
    norm = torch.linalg.norm
    return {
        "dot_c_xbar": torch.dot(lp.c, x_bar),
        "dot_yobj_ybar": torch.dot(y_obj, y_bar),
        "dot_xbar_zbar": torch.dot(x_bar, z_bar),
        "nrm_Rd": norm(Rd),
        "nrm_Rp": norm(Rp),
        "gap_dot": gap_dot,
        "gap_dy2": gap_dy2,
        "gap_dx2": gap_dx2,
        "move_x": norm(x_bar - last_x),
        "move_y": norm(y_bar - last_y),
        "nrm_lu_viol": norm(viol / scal.col_norm),
    }


def run_chunk(lp: LpDevice, scal: ScalingInfo, state: SolverState,
              sigma, lambda_max, restart_flag, n_iters: int):
    """Run n_iters (>= 2) HPR iterations and a residual check.

    restart_flag: 0-dim bool tensor -- apply the pending restart (anchor <-
    bars, iterate <- bars, inner <- 0; reference: src/main_iterate.cu:
    312-322) before iterating.  The first iteration's fixed-point gap
    components are returned (fs_*) for the post-restart last_gap.

    Returns (new_state, metrics dict of 0-dim tensors).
    """
    dtype = lp.c.dtype
    lam_sigma = lambda_max * sigma

    x = torch.where(restart_flag, state.x_bar, state.x)
    y = torch.where(restart_flag, state.y_bar, state.y)
    last_x = torch.where(restart_flag, state.x_bar, state.last_x)
    last_y = torch.where(restart_flag, state.y_bar, state.last_y)
    inner = torch.where(restart_flag, 0, state.inner)

    # First iteration (check-style: also produces bars for the post-restart
    # gap measurement).
    fact1, fact2 = _halpern_factors(inner, dtype)
    x1, x_hat, x_bar1, _ = _x_half(lp, x, y, last_x, sigma, fact1, fact2)
    y1, y_bar1, _ = _y_half(lp, y, x_hat, last_y, lam_sigma, fact1, fact2)
    fs_dot, fs_dy2, fs_dx2 = _fixed_point_gap_parts(lp, x - x_bar1,
                                                    y - y_bar1)
    inner = inner + 1

    # Middle iterations: plain updates.
    x2, y2 = x1, y1
    for _ in range(1, n_iters - 1):
        f1, f2 = _halpern_factors(inner, dtype)
        x2, x_hat, _, _ = _x_half(lp, x1, y1, last_x, sigma, f1, f2)
        y2, _, _ = _y_half(lp, y1, x_hat, last_y, lam_sigma, f1, f2)
        x1, y1 = x2, y2
        inner = inner + 1

    # Final iteration (check-style).
    f1, f2 = _halpern_factors(inner, dtype)
    x_f, x_hat, x_bar, z_tmp = _x_half(lp, x2, y2, last_x, sigma, f1, f2)
    z_bar = (x_bar - z_tmp) / sigma
    y_f, y_bar, y_obj = _y_half(lp, y2, x_hat, last_y, lam_sigma, f1, f2)
    inner = inner + 1

    metrics = _residual_metrics(lp, scal, x_bar, y_bar, z_bar, y_obj,
                                x2 - x_bar, y2 - y_bar, last_x, last_y)
    metrics["fs_dot"] = fs_dot
    metrics["fs_dy2"] = fs_dy2
    metrics["fs_dx2"] = fs_dx2

    new_state = SolverState(x=x_f, y=y_f, last_x=last_x, last_y=last_y,
                            x_bar=x_bar, y_bar=y_bar, z_bar=z_bar,
                            y_obj=y_obj, inner=inner)
    return new_state, metrics


def initial_metrics(lp: LpDevice, scal: ScalingInfo, state: SolverState):
    """Residual metrics of the initial bars -- the reference computes
    residuals at iteration 0 before any update (src/HPRLP.cu:178-196)."""
    zn = torch.zeros_like(state.x)
    zm = torch.zeros_like(state.y)
    m = _residual_metrics(lp, scal, state.x_bar, state.y_bar, state.z_bar,
                          state.y_obj, zn, zm, state.last_x, state.last_y)
    zero = torch.zeros((), dtype=zn.dtype, device=zn.device)
    m["fs_dot"] = zero
    m["fs_dy2"] = zero
    m["fs_dx2"] = zero
    return m


def unscale_solution(scal: ScalingInfo, state: SolverState):
    """Map the scaled bars back to the original space (reference:
    src/utils.cu:143-200 collect_solution):
        x = b_scale * x_bar / col_norm
        y = c_scale * y_bar / row_norm
        z = c_scale * z_bar * col_norm
    """
    x = scal.b_scale * state.x_bar / scal.col_norm
    y = scal.c_scale * state.y_bar / scal.row_norm
    z = scal.c_scale * state.z_bar * scal.col_norm
    return x, y, z
