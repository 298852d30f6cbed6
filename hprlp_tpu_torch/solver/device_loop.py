"""Restart/sigma control and stopping over a run of chunks.

Port of hprlp_tpu/solver/device_loop.py.  PyTorch has no traced while loop;
its counterpart here is a CUDA graph.  One chunk boundary -- the decision
(merit norm with the lambda self-correction, the sufficient/necessary/long
restart conditions, sigma re-estimation), stall recovery, the 150-iteration
chunk, the stopping test and the boundary's record -- is `ChunkStep.step`,
which reads and writes static buffers only, with every value, the
iteration count `it` included, a torch op on device tensors in the solve
dtype, as in JAX.  On the card, the solve captures the step once
(`capture_superchunk`) and run_superchunk replays it, reading each chunk's
small record (the metrics, sigma, flags, KKT and the stop test) from
pinned host memory one chunk behind the card.  On the CPU, and for
comparisons on the card (`graph=False`), the same step runs eagerly, once
per chunk.  Either way the loop stops at the first checkpoint whose KKT
error is below stop_tol, so the returned state is that checkpoint's state;
a step after it leaves every buffer as it was.

Semantics mirror the JAX package exactly (same conditions, same ordering:
decide from the PREVIOUS chunk's metrics, then iterate).  The TPU-only
pair-arithmetic merit norm (_m_norm_dev_pair) has no counterpart: the GPU's
f64 is native.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .chunk import SolverState, run_chunk
from .graph import StepGraph, commit, warmup_stream

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
                    obj_constant, is_iter0):
    """Original-space KKT residual pieces.  is_iter0: a bool, or a bool
    tensor that selects the iteration-0 primal residual on the device."""
    obj_scale = b_scale * c_scale
    p_obj = obj_scale * m["dot_c_xbar"] + obj_constant
    d_obj = obj_scale * (m["dot_yobj_ybar"] + m["dot_xbar_zbar"]) + obj_constant
    rel_gap = (p_obj - d_obj).abs() / (1.0 + p_obj.abs() + d_obj.abs())
    err_Rd = c_scale * m["nrm_Rd"] / norm_c_org
    err_Rp = b_scale * m["nrm_Rp"] / norm_b_org
    if torch.is_tensor(is_iter0):
        err_Rp = torch.where(
            is_iter0, torch.maximum(err_Rp, b_scale * m["nrm_lu_viol"]),
            err_Rp)
    elif is_iter0:
        err_Rp = torch.maximum(err_Rp, b_scale * m["nrm_lu_viol"])
    return err_Rp, err_Rd, rel_gap


def _residuals_dev(m, scal, obj_constant, is_iter0):
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


def it_tensor(it, device) -> torch.Tensor:
    """The iteration count as a 0-dim int64 tensor on `device` (a host int
    is copied there, so not inside a capture)."""
    if torch.is_tensor(it):
        return it
    return torch.tensor(it, dtype=torch.int64, device=device)


def fifth_of(it: torch.Tensor, dtype) -> torch.Tensor:
    """0.2 * it rounded to `dtype`: the value a host float 0.2 * it takes
    when compared with a `dtype` tensor (the long-restart test)."""
    return (0.2 * it.to(torch.float64)).to(dtype)


def _decide_and_update(rd: RestartDev, sigma, lam, m_prev, scal,
                       obj_constant, it, check_iter: int, dtype):
    """check_restart + update_sigma (reference main_iterate.cu:324-404),
    branch-free on the device.  `it`: the iteration count, a 0-dim int64
    device tensor (or a host int); as JAX does with its traced `it`, both
    sides of each test on it are computed and one is selected with
    torch.where, which gives bitwise the values a host branch gives."""
    it = it_tensor(it, sigma.device)
    err_Rp, err_Rd, rel_gap = _residuals_dev(m_prev, scal, obj_constant,
                                             it == 0)
    norm, lam_fix = _m_norm_dev(sigma, lam, m_prev["gap_dot"],
                                m_prev["gap_dy2"], m_prev["gap_dx2"])
    later = it > 0
    cg = torch.where(later, norm, rd.current_gap)
    lam = torch.where(later, lam_fix, lam)

    # First restart (">=": the boundary may have been coarsened).
    fr = rd.first_restart & (it >= check_iter)
    est = ~rd.first_restart
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


class ChunkStep:
    """One chunk boundary of run_superchunk on static buffers.

    The buffers hold what the loop carries from one boundary to the next:
    the solver state, the restart state, sigma, lambda, the last metrics,
    the stall-recovery best point, the iteration count `it` and `done`;
    `row` receives the boundary's record (STACK_KEYS).  Everything the
    step reads from the host (stop_tol, obj_constant, the flags) is made
    here, before any capture, so `step()` copies nothing from the host and
    a CUDA graph can hold it whole.  The constructor copies its arguments
    into fresh buffers; `load` copies a call's arguments into them."""

    def __init__(self, lp, scal, state, rd: RestartDev, sigma, lam,
                 metrics, obj_constant, stop_tol: float, check_iter: int,
                 stall_patience: int = 0, it0: int = 0, best=None):
        device, dtype = lp.c.device, lp.c.dtype
        self.lp, self.scal, self.obj_c = lp, scal, obj_constant
        self.check, self.patience = check_iter, stall_patience
        self.stop_tol = stop_tol
        self.stop_tol_dev = torch.tensor(stop_tol, dtype=dtype,
                                         device=device)
        self.no_stall = torch.tensor(False, device=device)
        self.state = copied(state)
        self.rd = copied(rd)
        self.sigma, self.lam = sigma.clone(), lam.clone()
        self.m = {k: metrics[k].clone() for k in METRIC_KEYS}
        self.best = {k: v.clone()
                     for k, v in _best_or_start(best, state, sigma).items()}
        self.it = it_tensor(it0, device).clone()
        self.done = torch.zeros((), dtype=torch.bool, device=device)
        self.row = torch.zeros(len(STACK_KEYS), dtype=dtype, device=device)

    def _pairs(self, state, rd, sigma, lam, m, best):
        """(buffer, value) for every carried tensor."""
        return ([(getattr(self.state, f), getattr(state, f))
                 for f in field_names(SolverState)]
                + [(getattr(self.rd, f), getattr(rd, f))
                   for f in field_names(RestartDev)]
                + [(self.sigma, sigma), (self.lam, lam)]
                + [(self.m[k], m[k]) for k in METRIC_KEYS]
                + [(self.best[k], best[k]) for k in self.best])

    def load(self, state, rd, sigma, lam, metrics, it0: int, best) -> None:
        """Start a call of run_superchunk from these values (a buffer
        passed back as its own value is not copied)."""
        best = _best_or_start(best, state, sigma)
        for buf, value in self._pairs(state, rd, sigma, lam, metrics, best):
            if value is not buf:
                buf.copy_(value)
        self.it.fill_(it0)
        self.done.fill_(False)

    def carried(self):
        """(state, rd, sigma, lambda, metrics, best): the buffers."""
        return self.state, self.rd, self.sigma, self.lam, self.m, self.best

    def step(self) -> None:
        lp, scal, dtype = self.lp, self.scal, self.lp.c.dtype
        check, best = self.check, self.best
        rd, sigma, lam, flag = _decide_and_update(
            self.rd, self.sigma, self.lam, self.m, scal, self.obj_c, self.it,
            check, dtype)
        # Stall recovery, applied after the normal decision so that the
        # decision logic is untouched while it is dormant.
        stall = (rd.since_best >= self.patience if self.patience > 0
                 else self.no_stall)
        j = rd.stalls % 5
        rung = ((j + 1) // 2) * (1 - 2 * (j % 2))  # 0,-1,+1,-2,+2
        sigma_rec = best["sigma"] * torch.exp2(
            (2 * rung).to(torch.float32)).to(dtype)
        sigma = torch.where(stall, sigma_rec, sigma)
        state = dataclasses.replace(
            self.state,
            x_bar=torch.where(stall, best["x_bar"], self.state.x_bar),
            y_bar=torch.where(stall, best["y_bar"], self.state.y_bar))
        rd = dataclasses.replace(
            rd,
            save_gap=torch.where(stall, float("inf"), rd.save_gap),
            inner=torch.where(stall, 0.0, rd.inner),
            times=rd.times + (stall & ~flag).to(torch.int32),
            stalls=rd.stalls + stall.to(torch.int32),
            since_best=torch.where(stall, 0, rd.since_best))
        flag = flag | stall
        state, m = run_chunk(lp, scal, state, sigma, lam, flag, check)
        lg, lam_fix = _m_norm_dev(sigma, lam, m["fs_dot"], m["fs_dy2"],
                                  m["fs_dx2"])
        lam = torch.where(flag, lam_fix, lam)
        rd = dataclasses.replace(rd,
                                 last_gap=torch.where(flag, lg, rd.last_gap),
                                 inner=rd.inner + check)
        # Stopping on the NEW boundary's relative KKT error (the formula
        # the host uses) and the stall tracker: a >=3% improvement re-arms
        # the patience counter, any improvement refreshes the best point.
        err_Rp, err_Rd, rel_gap = _residuals_dev(m, scal, self.obj_c, False)
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
        # After the first converged boundary (the JAX while_loop exits
        # there) a step leaves every buffer as it was.
        keep = self.done
        done = keep | (kkt < self.stop_tol_dev)
        row = torch.stack([m[k].to(dtype) for k in METRIC_KEYS]
                          + [sigma, flag.to(dtype), stall.to(dtype), kkt,
                             done.to(dtype)])
        commit(keep, self._pairs(state, rd, sigma, lam, m, best)
               + [(self.it, self.it + check), (self.row, row)])
        self.done.copy_(done)


def _best_or_start(best, state, sigma):
    """The stall-recovery best point: `best`, or at the start (None) the
    state's bars and sigma."""
    if best is None:
        return {"x_bar": state.x_bar, "y_bar": state.y_bar, "sigma": sigma}
    return best


def field_names(cls) -> list[str]:
    return [f.name for f in dataclasses.fields(cls)]


def copied(obj):
    """A dataclass of tensors with every tensor copied."""
    return dataclasses.replace(
        obj, **{f: getattr(obj, f).clone() for f in field_names(type(obj))})


def capture_superchunk(lp, scal, state, rd: RestartDev, sigma, lambda_max,
                       metrics, obj_constant, stop_tol: float,
                       check_iter: int, stall_patience: int = 0,
                       n_chunks: int = 128) -> StepGraph:
    """The solve's ChunkStep, warmed up on a copy of these values and
    captured in a CUDA graph (graph.StepGraph), for run_superchunk calls of
    up to n_chunks chunks.  On the card only; a failed capture raises.

    On a mesh (lp's matrices sharded) the step's all-reduces or
    all-gathers are captured with it.  NCCL sets a communicator up at its
    first collective, which a capture cannot hold, so one collective runs
    on the warm-up stream first, and the capture runs in the
    "thread_local" error mode."""
    shard = lp.A.sharding
    if shard is not None:
        side = warmup_stream(lp.c.device)
        side.wait_stream(torch.cuda.current_stream(lp.c.device))
        with torch.cuda.stream(side):
            dist.all_reduce(torch.zeros(1, dtype=lp.c.dtype,
                                        device=lp.c.device),
                            group=shard.group)
        torch.cuda.current_stream(lp.c.device).wait_stream(side)
    step = ChunkStep(lp, scal, state, rd, sigma, lambda_max, metrics,
                     obj_constant, stop_tol, check_iter, stall_patience)
    return StepGraph(step, n_chunks, capture_error_mode=(
        "global" if shard is None else "thread_local"))


def run_superchunk(lp, scal, state, rd: RestartDev, sigma, lambda_max,
                   metrics_prev, it0: int, obj_constant, stop_tol: float,
                   n_chunks: int, check_iter: int, stall_patience: int = 0,
                   best=None, graph=None):
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

    graph: the StepGraph of capture_superchunk, made with the same lp,
    scal, obj_constant, stop_tol, check_iter and stall_patience, whose
    replays then run the chunks; False runs the same step eagerly, once
    per chunk.  None is False on the CPU and raises on the card, so that
    nothing there takes the eager route unasked.

    Returns (state, rd, sigma, lambda_max, m_last, stacked, k_done, best):
    stacked maps each of STACK_KEYS to a float64 numpy array of the k_done
    chunks run.  With a graph, the returned tensors are its buffers, which
    the next call overwrites.
    """
    if graph is None and lp.c.device.type != "cpu":
        raise ValueError("on the card run_superchunk replays the graph of "
                         "capture_superchunk; graph=False runs eagerly")
    if graph:
        step = graph.step
        if (step.lp is not lp or step.check != check_iter
                or step.patience != stall_patience
                or step.stop_tol != stop_tol):
            raise ValueError("the graph was captured for another LP or "
                             "other settings")
        step.load(state, rd, sigma, lambda_max, metrics_prev, it0, best)
        rows = graph.run(n_chunks, lambda row: bool(row[-1]))
    else:
        step = ChunkStep(lp, scal, state, rd, sigma, lambda_max,
                         metrics_prev, obj_constant, stop_tol, check_iter,
                         stall_patience, it0, best)
        rows = []
        for _ in range(n_chunks):
            step.step()
            rows.append(step.row.cpu().numpy().astype(np.float64))
            if rows[-1][-1]:
                break
    table = np.stack(rows)
    stacked = {k: table[:, i] for i, k in enumerate(STACK_KEYS)}
    state, rd, sigma, lam, m, best = step.carried()
    return state, rd, sigma, lam, m, stacked, len(rows), best
