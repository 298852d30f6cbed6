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

A middle iteration's two halves go through `x_half` and `y_half`: on the
card, with A on the tiles or on the "gather" backend, each is one launch
of that backend's SpMV kernel with the half fused into its row write
(ops/spmv.py::tiled_x_half, tiled_y_half; spmv_x_half, spmv_y_half),
bitwise equal to its plain ops; elsewhere (a dense copy, the CPU) the
plain ops (`x_half_plain`, `y_half_plain`).  The first and last
iterations of a chunk stay plain.  On a mesh's column shards the tiled
kernel on this rank's slice gives a partial product, one all-reduce sums
the ranks' partials (ops/sparse.py::spmv), and one launch of the epilogue
kernel (tiled_half_epilogue, whose plain version is `x_update` or
`y_update`) applies the half to the whole replicated vector on every
rank.  On a mesh's row shards the fused half runs on this rank's rows
(A^T[C, :] with x[C], last_x[C], c[C], l[C], u[C]; A[R, :] with y[R],
last_y[R], AL[R], AU[R]) against the whole operand, and one all-gather
puts the ranks' rows together (x_new and x_hat packed into one).  Either
way every vector is replicated again, so the rest of the chunk runs as on
one card.

The TPU package's double-f32 chunk (_df64_chunk_iters) has no counterpart:
the GPU has native f64.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops.device_problem import LpDevice
from ..ops.sparse import all_gather_rows, spmv, spmv_backend
from ..ops.spmv import (spmv_x_half, spmv_y_half, tiled_half_epilogue,
                        tiled_x_half, tiled_y_half)
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


def x_update(lp, x, ATy, last_x, sigma, fact1, fact2):
    """The x-half's elementwise ops given ATy = A^T y: (x_new, x_hat, x_bar,
    z_tmp).  The plain version of ops/spmv.py::tiled_half_epilogue("x")."""
    z_tmp = x + sigma * (ATy - lp.c)
    x_bar = torch.clamp(z_tmp, lp.l, lp.u)
    x_hat = 2.0 * x_bar - x
    x_new = fact2 * x_hat + fact1 * last_x
    return x_new, x_hat, x_bar, z_tmp


def y_update(lp, y, Ax, last_y, lam_sigma, fact1, fact2):
    """The y-half's elementwise ops given Ax = A x_hat: (y_new, y_bar,
    v + d).  The plain version of tiled_half_epilogue("y")."""
    v = Ax - lam_sigma * y
    d = torch.maximum(lp.AL - v, torch.clamp(lp.AU - v, max=0.0))
    y_bar = d / lam_sigma
    y_hat = 2.0 * y_bar - y
    y_new = fact2 * y_hat + fact1 * last_y
    return y_new, y_bar, v + d


def _x_half(lp, x, y, last_x, sigma, fact1, fact2):
    return x_update(lp, x, spmv(lp.AT, y), last_x, sigma, fact1, fact2)


def _y_half(lp, y, x_hat, last_y, lam_sigma, fact1, fact2):
    return y_update(lp, y, spmv(lp.A, x_hat), last_y, lam_sigma, fact1,
                    fact2)


class Halpern:
    """The Halpern counter of one middle iteration, inner + t (inner: the
    0-dim int32 counter at the first middle iteration, t: this iteration's
    index among them), for its two halves: the plain ones share its
    factors, made once on first use; the fused ones read inner and t on
    the card."""

    def __init__(self, inner: torch.Tensor, t: int, dtype: torch.dtype):
        self.inner, self.t, self.dtype = inner, t, dtype

    @functools.cached_property
    def factors(self):
        return _halpern_factors(self.inner + self.t, self.dtype)


def x_half_plain(lp, x, y, last_x, sigma, h: Halpern):
    """A middle iteration's x-half in plain ops: _x_half with the factors
    of h.  Returns (x_new, x_hat)."""
    x_new, x_hat, _, _ = _x_half(lp, x, y, last_x, sigma, *h.factors)
    return x_new, x_hat


def y_half_plain(lp, y, x_hat, last_y, lam_sigma, h: Halpern):
    """A middle iteration's y-half in plain ops.  Returns y_new."""
    return _y_half(lp, y, x_hat, last_y, lam_sigma, *h.factors)[0]


def _fused(M, v: torch.Tensor) -> bool:
    """Whether a half over M's rows runs as a hand-written kernel: its
    operand on the card and M on the tiles (the tiled kernel) or on
    "gather" (the CSR kernel).  A dense copy's product and a CPU operand
    take the plain ops."""
    return v.device.type == "cuda" and spmv_backend(M) in ("tiled", "gather")


def x_half(lp, x, y, last_x, sigma, h: Halpern):
    """x_half_plain, fused into A^T y's row write where _fused holds: on the
    tiles, or on a column shard the sharded product then the epilogue
    kernel; on a row shard, over this rank's rows, then gathered."""
    M = lp.AT
    if not _fused(M, y):
        return x_half_plain(lp, x, y, last_x, sigma, h)
    rows = (x, last_x, lp.c, lp.l, lp.u)
    if spmv_backend(M) == "tiled":
        if M.shard is None:
            return tiled_x_half(M.tiles, y, *rows, sigma, h.inner, h.t)
        return tiled_half_epilogue("x", spmv(M, y), rows, sigma, h.inner,
                                   h.t)
    rs = M.row_shard
    if rs is None:
        return spmv_x_half(M, y, *rows, sigma, h.inner, h.t)
    k = slice(rs.r0, rs.r1)
    parts = spmv_x_half(M.rows_local(), y, *(r[k] for r in rows), sigma,
                        h.inner, h.t)
    x_new, x_hat = all_gather_rows(parts, rs)
    return x_new, x_hat


def y_half(lp, y, x_hat, last_y, lam_sigma, h: Halpern):
    """y_half_plain, fused into A x_hat's row write where _fused holds, as
    x_half is."""
    M = lp.A
    if not _fused(M, x_hat):
        return y_half_plain(lp, y, x_hat, last_y, lam_sigma, h)
    rows = (y, last_y, lp.AL, lp.AU)
    if spmv_backend(M) == "tiled":
        if M.shard is None:
            return tiled_y_half(M.tiles, x_hat, *rows, lam_sigma, h.inner,
                                h.t)
        return tiled_half_epilogue("y", spmv(M, x_hat), rows, lam_sigma,
                                   h.inner, h.t)
    rs = M.row_shard
    if rs is None:
        return spmv_y_half(M, x_hat, *rows, lam_sigma, h.inner, h.t)
    k = slice(rs.r0, rs.r1)
    part = spmv_y_half(M.rows_local(), x_hat, *(r[k] for r in rows),
                       lam_sigma, h.inner, h.t)
    return all_gather_rows([part], rs)[0]


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

    # Middle iterations: plain updates, each half fused into its SpMV on
    # the card (x_half, y_half); the counter advances once after.
    x2, y2 = x1, y1
    for t in range(n_iters - 2):
        h = Halpern(inner, t, dtype)
        x2, x_hat = x_half(lp, x2, y2, last_x, sigma, h)
        y2 = y_half(lp, y2, x_hat, last_y, lam_sigma, h)
    inner = inner + (n_iters - 2)

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
