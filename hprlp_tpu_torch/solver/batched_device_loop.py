"""Per-member restart/sigma control and stopping over a run of batched
chunks.

Port of hprlp_tpu/solver/batched_device_loop.py, in the style of
solver/device_loop.py: PyTorch has no traced while loop, so
run_batched_superchunk is a Python loop over chunks.  Every decision stays
a torch op on (B,) device tensors in the solve dtype; only the iteration
count `it` is a host int.  Each chunk ends with ONE host read of a small
stacked (keys, B) tensor (the metrics, sigma, the restart flags, the
active mask during the chunk and after its stopping test), and the loop
stops once no member is active.

The M-norm, residual and sigma-chain math is the single-LP loop's
(device_loop._m_norm_dev/_residuals_core/_sigma_chain): all three are
elementwise and take (B,) tensors unchanged, as the JAX module reuses its
own.  Semantics that differ from the single-LP loop are the reference's
and are kept: every member passes the first-restart boundary together
(clear_fr below), the Halpern counter advances only for active members,
and there is no stall recovery.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .batched import run_batched_chunk
from .device_loop import (METRIC_KEYS, _m_norm_dev, _residuals_core,
                          _sigma_chain)

# Per-chunk host record: the metrics, then these ("active" is the mask the
# chunk ran with, "active_after" the mask after its stopping test).
STACK_KEYS = METRIC_KEYS + ("sigma", "flag", "active", "active_after")


@dataclasses.dataclass(frozen=True)
class BatchedRestartDev:
    """Per-member device restart state (parity: BatchedRestartHost,
    reference: src/batched_solver.cu:103-120).  Every field is (B,)."""

    first_restart: torch.Tensor  # bool
    last_gap: torch.Tensor
    current_gap: torch.Tensor
    save_gap: torch.Tensor
    best_gap: torch.Tensor
    best_sigma: torch.Tensor
    inner: torch.Tensor
    times: torch.Tensor  # int32


def init_batched_restart_dev(sigma: torch.Tensor, dtype) -> BatchedRestartDev:
    B, device = sigma.shape[0], sigma.device
    inf = torch.full((B,), float("inf"), dtype=dtype, device=device)
    return BatchedRestartDev(
        first_restart=torch.ones(B, dtype=torch.bool, device=device),
        last_gap=inf, current_gap=inf, save_gap=inf, best_gap=inf,
        best_sigma=sigma.to(dtype),
        inner=torch.zeros(B, dtype=dtype, device=device),
        times=torch.zeros(B, dtype=torch.int32, device=device))


def _bdecide(rd: BatchedRestartDev, sigma, lam, active, m_prev, b_scale,
             c_scale, norm_b_org, norm_c_org, obj_constants, it: int,
             check_iter: int, dtype):
    """Vectorised check_restart + update_sigma (reference
    src/batched_solver.cu:667-762 semantics); `it` is the host iteration
    count."""
    err_Rp, err_Rd, rel_gap = _residuals_core(
        m_prev, b_scale, c_scale, norm_b_org, norm_c_org, obj_constants,
        it == 0)
    if it > 0:
        cg, lam = _m_norm_dev(sigma, lam, m_prev["gap_dot"],
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

    sigma_new = _sigma_chain(m_prev, lam, current_gap, best_gap, best_sigma,
                             err_Rp, err_Rd, rel_gap, sigma, flag, dtype)

    # All members pass the first-restart boundary together (the reference's
    # rule; converged members are frozen anyway).
    clear_fr = fr.any()
    rd_new = BatchedRestartDev(
        first_restart=rd.first_restart & ~clear_fr,
        last_gap=rd.last_gap,
        current_gap=current_gap,
        save_gap=torch.where(flag, float("inf"), save_gap),
        best_gap=best_gap,
        best_sigma=best_sigma,
        inner=torch.where(flag, 0.0, rd.inner),
        times=rd.times + flag.to(torch.int32))
    return rd_new, sigma_new, lam, flag, (err_Rp, err_Rd, rel_gap)


def run_batched_superchunk(lp, row_norm, col_norm, state,
                           rd: BatchedRestartDev, sigma, lam, active,
                           metrics_prev, it0: int, b_scale, c_scale,
                           norm_b_org, norm_c_org, obj_constants,
                           stop_tol: float, n_chunks: int, check_iter: int):
    """Advance up to n_chunks * check_iter iterations with per-member
    restarts, sigma updates and stopping: a member whose relative KKT
    error drops below stop_tol is frozen (active False) at that chunk
    boundary; the loop ends early once every member is frozen.

    Returns (state, rd, sigma, lam, active, m_last, stacked, k_done):
    stacked maps each of STACK_KEYS to a float64 numpy array of shape
    (k_done, B).
    """
    dtype, device = lp.c.dtype, lp.c.device
    stop_tol_dev = torch.tensor(stop_tol, dtype=dtype, device=device)
    m = metrics_prev
    it = it0
    rows = []
    for _ in range(n_chunks):
        rd, sigma, lam, flag, _ = _bdecide(
            rd, sigma, lam, active, m, b_scale, c_scale, norm_b_org,
            norm_c_org, obj_constants, it, check_iter, dtype)
        state, m = run_batched_chunk(lp, row_norm, col_norm, state, sigma,
                                     lam, flag, active, check_iter)
        lg, lam_fix = _m_norm_dev(sigma, lam, m["fs_dot"], m["fs_dy2"],
                                  m["fs_dx2"])
        # Both gated on the restart flag, as in the single-LP loop: a
        # boundary without a restart must not move lambda from stale fs_*.
        lam = torch.where(flag, lam_fix, lam)
        rd = dataclasses.replace(
            rd, last_gap=torch.where(flag, lg, rd.last_gap),
            inner=rd.inner + torch.where(active, float(check_iter), 0.0))
        it += check_iter
        # Per-member stopping on the NEW boundary.
        err_Rp, err_Rd, rel_gap = _residuals_core(
            m, b_scale, c_scale, norm_b_org, norm_c_org, obj_constants,
            False)
        kkt = torch.maximum(torch.maximum(err_Rp, err_Rd), rel_gap)
        was_active = active
        active = active & (kkt >= stop_tol_dev)
        row = torch.stack([m[k].to(dtype) for k in METRIC_KEYS]
                          + [sigma, flag.to(dtype), was_active.to(dtype),
                             active.to(dtype)])
        rows.append(row.cpu().numpy().astype(np.float64))  # one host read
        if not rows[-1][-1].any():
            break
    table = np.stack(rows)
    stacked = {k: table[:, i] for i, k in enumerate(STACK_KEYS)}
    return state, rd, sigma, lam, active, m, stacked, len(rows)
