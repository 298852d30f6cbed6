"""Per-member restart/sigma control and stopping over a run of batched
chunks.

Port of hprlp_tpu/solver/batched_device_loop.py, in the style of
solver/device_loop.py: one chunk boundary is `BatchedChunkStep.step`, on
static buffers, every decision a torch op on (B,) device tensors in the
solve dtype and the iteration count `it` a device tensor.  On the card the
solve captures it once in a CUDA graph (`capture_batched_superchunk`) and
run_batched_superchunk replays it, reading each chunk's small stacked
(keys, B) record (the metrics, sigma, the restart flags, the active mask
during the chunk and after its stopping test) one chunk behind the card;
on the CPU, and with graph=False, the step runs eagerly.  The loop stops
once no member is active; a step after that leaves every buffer as it
was.

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

from .batched import BatchedState, run_batched_chunk
from .device_loop import (METRIC_KEYS, _m_norm_dev, _residuals_core,
                          _sigma_chain, copied, field_names, fifth_of,
                          it_tensor)
from .graph import StepGraph, commit

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
             c_scale, norm_b_org, norm_c_org, obj_constants, it,
             check_iter: int, dtype):
    """Vectorised check_restart + update_sigma (reference
    src/batched_solver.cu:667-762 semantics); `it` is the iteration count,
    a 0-dim int64 device tensor (or a host int), tested on the device as
    in device_loop._decide_and_update."""
    it = it_tensor(it, sigma.device)
    err_Rp, err_Rd, rel_gap = _residuals_core(
        m_prev, b_scale, c_scale, norm_b_org, norm_c_org, obj_constants,
        it == 0)
    norm, lam_fix = _m_norm_dev(sigma, lam, m_prev["gap_dot"],
                                m_prev["gap_dy2"], m_prev["gap_dx2"])
    later = it > 0
    cg = torch.where(later, norm, rd.current_gap)
    lam = torch.where(later, lam_fix, lam)

    fr = rd.first_restart & active & (it >= check_iter)
    est = ~rd.first_restart & active
    cg_est = torch.where(cg < 0, 1e-6, cg)
    sufficient = est & (cg_est <= 0.2 * rd.last_gap)
    necessary = est & (cg_est <= 0.6 * rd.last_gap) & (cg_est > rd.save_gap)
    long_r = est & (rd.inner >= fifth_of(it, rd.inner.dtype))
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


class BatchedChunkStep:
    """One chunk boundary of run_batched_superchunk on static buffers, as
    device_loop.ChunkStep: the state, restart state, sigma, lambda, active
    mask, last metrics and `it` are buffers, `row` receives the boundary's
    (STACK_KEYS, B) record, and a step that starts with no member active
    leaves every buffer as it was."""

    def __init__(self, lp, row_norm, col_norm, state, rd: BatchedRestartDev,
                 sigma, lam, active, metrics, b_scale, c_scale, norm_b_org,
                 norm_c_org, obj_constants, stop_tol: float,
                 check_iter: int, it0: int = 0):
        device, dtype = lp.c.device, lp.c.dtype
        self.lp, self.row_norm, self.col_norm = lp, row_norm, col_norm
        self.scales = (b_scale, c_scale, norm_b_org, norm_c_org,
                       obj_constants)
        self.check, self.stop_tol = check_iter, stop_tol
        self.stop_tol_dev = torch.tensor(stop_tol, dtype=dtype,
                                         device=device)
        self.state, self.rd = copied(state), copied(rd)
        self.sigma, self.lam = sigma.clone(), lam.clone()
        self.active = active.clone()
        self.m = {k: metrics[k].clone() for k in METRIC_KEYS}
        self.it = it_tensor(it0, device).clone()
        self.row = torch.zeros((len(STACK_KEYS), sigma.shape[0]),
                               dtype=dtype, device=device)

    def _pairs(self, state, rd, sigma, lam, active, m):
        """(buffer, value) for every carried tensor."""
        return ([(getattr(self.state, f), getattr(state, f))
                 for f in field_names(BatchedState)]
                + [(getattr(self.rd, f), getattr(rd, f))
                   for f in field_names(BatchedRestartDev)]
                + [(self.sigma, sigma), (self.lam, lam),
                   (self.active, active)]
                + [(self.m[k], m[k]) for k in METRIC_KEYS])

    def load(self, state, rd, sigma, lam, active, metrics,
             it0: int) -> None:
        """Start a call from these values (a buffer passed back as its own
        value is not copied)."""
        for buf, value in self._pairs(state, rd, sigma, lam, active,
                                      metrics):
            if value is not buf:
                buf.copy_(value)
        self.it.fill_(it0)

    def carried(self):
        """(state, rd, sigma, lambda, active, metrics): the buffers."""
        return (self.state, self.rd, self.sigma, self.lam, self.active,
                self.m)

    def step(self) -> None:
        lp, dtype, check = self.lp, self.lp.c.dtype, self.check
        active = self.active
        rd, sigma, lam, flag, _ = _bdecide(
            self.rd, self.sigma, self.lam, active, self.m, *self.scales,
            self.it, check, dtype)
        state, m = run_batched_chunk(lp, self.row_norm, self.col_norm,
                                     self.state, sigma, lam, flag, active,
                                     check)
        lg, lam_fix = _m_norm_dev(sigma, lam, m["fs_dot"], m["fs_dy2"],
                                  m["fs_dx2"])
        # Both gated on the restart flag, as in the single-LP loop: a
        # boundary without a restart must not move lambda from stale fs_*.
        lam = torch.where(flag, lam_fix, lam)
        rd = dataclasses.replace(
            rd, last_gap=torch.where(flag, lg, rd.last_gap),
            inner=rd.inner + torch.where(active, float(check), 0.0))
        # Per-member stopping on the NEW boundary.
        err_Rp, err_Rd, rel_gap = _residuals_core(m, *self.scales, False)
        kkt = torch.maximum(torch.maximum(err_Rp, err_Rd), rel_gap)
        active_after = active & (kkt >= self.stop_tol_dev)
        row = torch.stack([m[k].to(dtype) for k in METRIC_KEYS]
                          + [sigma, flag.to(dtype), active.to(dtype),
                             active_after.to(dtype)])
        commit(~active.any(),
               self._pairs(state, rd, sigma, lam, active_after, m)
               + [(self.it, self.it + check), (self.row, row)])


def capture_batched_superchunk(lp, row_norm, col_norm, state,
                               rd: BatchedRestartDev, sigma, lam, active,
                               metrics, b_scale, c_scale, norm_b_org,
                               norm_c_org, obj_constants, stop_tol: float,
                               check_iter: int, n_chunks: int) -> StepGraph:
    """The batched solve's BatchedChunkStep, warmed up on a copy of these
    values and captured in a CUDA graph, for run_batched_superchunk calls
    of up to n_chunks chunks.  On the card only; a failed capture
    raises."""
    step = BatchedChunkStep(lp, row_norm, col_norm, state, rd, sigma, lam,
                            active, metrics, b_scale, c_scale, norm_b_org,
                            norm_c_org, obj_constants, stop_tol, check_iter)
    return StepGraph(step, n_chunks)


def run_batched_superchunk(lp, row_norm, col_norm, state,
                           rd: BatchedRestartDev, sigma, lam, active,
                           metrics_prev, it0: int, b_scale, c_scale,
                           norm_b_org, norm_c_org, obj_constants,
                           stop_tol: float, n_chunks: int, check_iter: int,
                           graph=None):
    """Advance up to n_chunks * check_iter iterations with per-member
    restarts, sigma updates and stopping: a member whose relative KKT
    error drops below stop_tol is frozen (active False) at that chunk
    boundary; the loop ends early once every member is frozen.

    graph: the StepGraph of capture_batched_superchunk (made with the same
    lp, scales, stop_tol and check_iter), whose replays then run the
    chunks; False runs the same step eagerly.  None is False on the CPU
    and raises on the card.

    Returns (state, rd, sigma, lam, active, m_last, stacked, k_done):
    stacked maps each of STACK_KEYS to a float64 numpy array of shape
    (k_done, B).  With a graph, the returned tensors are its buffers,
    which the next call overwrites.
    """
    if graph is None and lp.c.device.type != "cpu":
        raise ValueError("on the card run_batched_superchunk replays the "
                         "graph of capture_batched_superchunk; graph=False "
                         "runs eagerly")
    if graph:
        step = graph.step
        if (step.lp is not lp or step.check != check_iter
                or step.stop_tol != stop_tol):
            raise ValueError("the graph was captured for another problem "
                             "or other settings")
        step.load(state, rd, sigma, lam, active, metrics_prev, it0)
        rows = graph.run(n_chunks, lambda row: not row[-1].any())
    else:
        step = BatchedChunkStep(lp, row_norm, col_norm, state, rd, sigma,
                                lam, active, metrics_prev, b_scale, c_scale,
                                norm_b_org, norm_c_org, obj_constants,
                                stop_tol, check_iter, it0)
        rows = []
        for _ in range(n_chunks):
            step.step()
            rows.append(step.row.cpu().numpy().astype(np.float64))
            if not rows[-1][-1].any():
                break
    table = np.stack(rows)
    stacked = {k: table[:, i] for i, k in enumerate(STACK_KEYS)}
    state, rd, sigma, lam, active, m = step.carried()
    return state, rd, sigma, lam, active, m, stacked, len(rows)
