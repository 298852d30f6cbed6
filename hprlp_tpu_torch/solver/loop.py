"""Host orchestration of the solve (parity: HPRLP_main_solve, reference:
src/HPRLP.cu:116-310, restart/sigma logic src/main_iterate.cu:312-420).

Port of hprlp_tpu/solver/loop.py.  The pipeline is layout and upload ->
scaling -> SpMV backend (autotune.py) -> power method -> on the card, the
capture of one chunk boundary in a CUDA graph -> restart/sigma/stopping
loop over chunks (device_loop.run_superchunk, replaying the graph) ->
unscale.  Chunk boundaries reproduce the reference's schedule: every
check_iter iterations (restart + stopping).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..ops.device_problem import (attach_blocks, attach_tiles,
                                  build_device_problem)
from ..ops.sparse import spmv_backend
from ..ops.tiles import build_tiles
from ..params import Parameters
from ..problem import LpProblem
from ..results import Results
from .chunk import init_state, initial_metrics, unscale_solution
from .autotune import autotune_backends, set_spmv_backend
from .device_loop import capture_superchunk, init_restart_dev, run_superchunk
from .power_iteration import power_method
from .scaling import scale_problem

# On a CUDA device, precision="auto" runs f32 at stop_tol >= this and f64
# below it (the GPU's f64 is native, so "auto" never routes to the
# refinement of precision="mixed").
F64_BELOW_TOL = 1e-5


@dataclasses.dataclass
class Residuals:
    """Parity: HPRLP_residuals (reference: include/structs.h:255-263)."""

    err_Rp: float = math.inf
    err_Rd: float = math.inf
    primal_obj: float = 0.0
    dual_obj: float = 0.0
    rel_gap: float = math.inf
    kkt: float = math.inf


def _print_step(it: int) -> int:
    """Log-spaced print cadence (reference: src/utils.cu:100-102)."""
    if it <= 0:
        return 10
    return max(10, 10 ** int(math.floor(math.log10(it))) // 10)


def _derive_residuals(metrics: dict, scal_host: dict, obj_constant: float,
                      is_iter0: bool) -> Residuals:
    obj_scale = scal_host["b_scale"] * scal_host["c_scale"]
    r = Residuals()
    r.primal_obj = obj_scale * metrics["dot_c_xbar"] + obj_constant
    r.dual_obj = obj_scale * (metrics["dot_yobj_ybar"]
                              + metrics["dot_xbar_zbar"]) + obj_constant
    r.rel_gap = abs(r.primal_obj - r.dual_obj) / (
        1.0 + abs(r.primal_obj) + abs(r.dual_obj))
    r.err_Rd = scal_host["c_scale"] * metrics["nrm_Rd"] / scal_host["norm_c_org"]
    r.err_Rp = scal_host["b_scale"] * metrics["nrm_Rp"] / scal_host["norm_b_org"]
    if is_iter0:
        r.err_Rp = max(r.err_Rp, scal_host["b_scale"] * metrics["nrm_lu_viol"])
    r.kkt = max(r.err_Rd, r.err_Rp, r.rel_gap)
    return r


def resolve_device(params: Parameters, device=None) -> torch.device:
    """device=None means cuda:{params.device_number}; without CUDA that
    raises -- the solver never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to solve on the CPU")
        return torch.device(f"cuda:{params.device_number}")
    return torch.device(device)


def resolve_dtype(params: Parameters, device: torch.device) -> torch.dtype:
    """precision -> dtype.  "auto" is f64 on the CPU; on CUDA it is f32 at
    stop_tol >= F64_BELOW_TOL and native f64 below.  "mixed" reaches here
    only from solve_batched, which has no refinement: f64 on the CPU and
    f32 on CUDA, the JAX package's batched route."""
    if params.precision == "f64":
        return torch.float64
    if params.precision == "f32":
        return torch.float32
    if params.precision == "mixed":
        return torch.float64 if device.type == "cpu" else torch.float32
    if device.type == "cpu" or params.stop_tol < F64_BELOW_TOL:
        return torch.float64
    return torch.float32


def _check_supported(params: Parameters) -> None:
    if params.mesh_shape:
        raise NotImplementedError("mesh_shape (multi-device solves) is not "
                                  "ported yet (ROADMAP.md queue 1, multi-GPU)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def solve_problem(problem: LpProblem, params: Parameters | None = None,
                  x0=None, y0=None, sigma0=None, device=None) -> Results:
    """Full solve: upload -> scale -> SpMV backend -> power method -> HPR
    loop -> unscale.

    Parity: solve() + HPRLP_main_solve() (reference: src/HPRLP.cu:116-310)
    minus presolve.  x0/y0: optional warm-start points in the ORIGINAL
    space; sigma0: resume sigma from a prior solve of the same problem.
    device: a torch device; None means cuda:{params.device_number}.
    precision="mixed" runs refine.solve_refined (f32 stages, an f64 tail)
    on that device.

    spmv_backend: "auto" runs the autotune's choice on the card
    (autotune.py) and the tiled kernel's plain version on the CPU; "lane"
    is the tiled kernel without the autotune; "gather" and "dense" force
    the CSR kernel or a dense product (on the CPU their plain versions).  After the call, solve_problem.capture_time holds the
    seconds of the CUDA graph's warm-up and capture (None on the CPU),
    which no field of Results counts.
    """
    params = params or Parameters()
    params.validate()
    _check_supported(params)
    device = resolve_device(params, device)
    if params.precision == "mixed":
        from .refine import solve_refined

        return solve_refined(problem, params, x0=x0, y0=y0, device=device)
    dtype = resolve_dtype(params, device)
    log = print if params.verbose else (lambda *a, **k: None)

    out = Results()

    t_setup = time.perf_counter()
    solve_problem.capture_time = None
    lp_raw, maps = build_device_problem(problem, dtype=dtype, device=device)
    # The SpMV tiles' structure (ops/tiles.py) is layout and counts here;
    # the scaled values are gathered into it below, in scaling_time.
    # "gather" and "dense" never run on them.
    tiled = params.spmv_backend in ("auto", "lane")
    tiles = (build_tiles(lp_raw.A), build_tiles(lp_raw.AT)) if tiled else None
    # So is the CSR kernel's row-block plan ("gather", which the autotune
    # may choose); it holds no values, so the scaling keeps it.
    if params.spmv_backend in ("auto", "gather"):
        lp_raw = attach_blocks(lp_raw)
    _sync(device)
    out.setup_time = time.perf_counter() - t_setup
    log(f"Setup (layout and upload) time = {out.setup_time:.2f} seconds")

    t_scale = time.perf_counter()
    lp, scal = scale_problem(lp_raw,
                             use_cr=params.use_CR_scaling,
                             use_ruiz=params.use_Ruiz_scaling,
                             use_pc=params.use_Pock_Chambolle_scaling,
                             use_bc=params.use_bc_scaling)
    del lp_raw
    if tiled:
        lp = attach_tiles(lp, *tiles)
    del tiles
    scal_host = {k: float(getattr(scal, k)) for k in
                 ("b_scale", "c_scale", "norm_b", "norm_c",
                  "norm_b_org", "norm_c_org")}
    out.scaling_time = time.perf_counter() - t_scale
    log(f"Scaling time = {out.scaling_time:.2f} seconds")

    if sigma0 is not None:
        sigma = float(sigma0)
    elif scal_host["norm_b"] > 1e-8 and scal_host["norm_c"] > 1e-8:
        sigma = scal_host["norm_b"] / scal_host["norm_c"]
    else:
        sigma = 1.0

    state = init_state(lp)
    if x0 is not None:
        # Into the padded, scaled space (inverse of unscale_solution).
        xp = np.zeros(lp.n)
        xp[maps.col_pos] = np.asarray(x0, np.float64)
        xs = (torch.as_tensor(xp, device=device).to(dtype) * scal.col_norm
              / scal.b_scale)
        state = dataclasses.replace(state, x=xs, last_x=xs, x_bar=xs)
    if y0 is not None:
        yp = np.zeros(lp.m)
        yp[maps.row_pos] = np.asarray(y0, np.float64)
        ys = (torch.as_tensor(yp, device=device).to(dtype) * scal.row_norm
              / scal.c_scale)
        state = dataclasses.replace(state, y=ys, last_y=ys, y_bar=ys)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    # SpMV backend selection BEFORE the power method, so that it also runs
    # on the chosen backend (reference autotuner analogue, src/
    # main_iterate.cu:517-595).  Probes run 20 iterations with a
    # placeholder lambda_max: every candidate sees the same value.
    t_tune = time.perf_counter()
    if params.spmv_backend == "auto":
        probe_args = (scal, state, scalar(sigma), scalar(4.0),
                      torch.tensor(False, device=device),
                      min(20, params.check_iter))
        lp = autotune_backends(lp, probe_args,
                               verbose=params.autotune_verbose)
    elif params.spmv_backend in ("gather", "dense"):
        lp = set_spmv_backend(lp, params.spmv_backend)
    out.autotune_time = time.perf_counter() - t_tune

    t_pm = time.perf_counter()
    # Floor guards the degenerate all-zero-A case (zero-constraint LPs).
    lambda_max = max(float(power_method(lp)) * 1.01, 1e-12)
    out.power_time = time.perf_counter() - t_pm
    log(f"ESTIMATING MAXIMUM EIGENVALUE time = {out.power_time:.2f} seconds")

    obj_constant = maps.obj_constant
    obj_c_dev = scalar(obj_constant)
    rd = init_restart_dev(sigma, dtype, device)
    sigma_dev = scalar(sigma)
    lam_dev = scalar(lambda_max)
    check = params.check_iter
    metrics_prev = initial_metrics(lp, scal, state)
    best_pt = None  # the stall-recovery best point: the start, at first
    stall_patience = int(params.stall_recovery or 0)

    # On the card, one chunk boundary captured in a CUDA graph, warmed up
    # on a copy of the state, before the algorithm clock, as the JAX
    # package compiles its superchunk before its clock (and the reference
    # captures its graphs in setup, src/HPRLP.cu:99-114).
    graph = None
    if device.type == "cuda":
        graph = capture_superchunk(lp, scal, state, rd, sigma_dev, lam_dev,
                                   metrics_prev, obj_c_dev, params.stop_tol,
                                   check, stall_patience)
        solve_problem.capture_time = graph.capture_s
        log(f"CUDA graph capture time = {graph.capture_s:.2f} seconds")

    # --- algorithm clock starts here, after the power method ---
    _sync(device)
    t_alg = time.perf_counter()

    def elapsed():
        return time.perf_counter() - t_alg

    first = {1e-4: True, 1e-6: True, 1e-8: True}
    stall_events = 0
    it = 0
    log(" iter     errRp        errRd         p_obj            d_obj"
        "          gap         sigma       time")

    def host_res(m_host, at_it):
        return _derive_residuals(m_host, scal_host, obj_constant, at_it == 0)

    def finish(status, at_it, res, sigma_val, restarts):
        # The card may still run the replay queued behind the last chunk
        # read (graph.StepGraph.run's lookahead): the point is ready after.
        _sync(device)
        out.status = status
        out.spmv_backend = spmv_backend(lp.A)
        out.iter = at_it
        out.gap = res.rel_gap
        out.residuals = res.kkt
        out.primal_obj = res.primal_obj
        out.dual_obj = res.dual_obj
        out.time = elapsed()
        out.restarts = restarts
        out.stall_recoveries = stall_events
        out.sigma_final = float(sigma_val)
        if out.time4 == 0.0 and first[1e-4]:
            out.iter4, out.time4 = out.iter, out.time
        if out.time6 == 0.0 and first[1e-6]:
            out.iter6, out.time6 = out.iter, out.time
        if out.time8 == 0.0 and first[1e-8]:
            out.iter8, out.time8 = out.iter, out.time
        x_s, y_s, z_s = (v.cpu().numpy().astype(np.float64)
                         for v in unscale_solution(scal, state))
        out.x = x_s[maps.col_pos]
        out.y = y_s[maps.row_pos]
        out.z = z_s[maps.col_pos]
        log(f"\n=== Solution Summary ===\nStatus: {out.status}\n"
            f"Iterations: {out.iter}\nTime: {out.time:.2f} seconds\n"
            f"Primal Objective: {out.primal_obj:.12e}\n"
            f"Residual: {out.residuals:.2e}\n")
        return out

    def milestones(res, at_it, at_time):
        for tol, (attr_i, attr_t) in ((1e-4, ("iter4", "time4")),
                                      (1e-6, ("iter6", "time6")),
                                      (1e-8, ("iter8", "time8"))):
            if first[tol] and res.kkt < tol:
                setattr(out, attr_i, at_it)
                setattr(out, attr_t, at_time)
                first[tol] = False
                log(f"Residual < {tol:.0e} at iter = {at_it}")

    m0 = {k: float(v) for k, v in metrics_prev.items()}
    res = host_res(m0, 0)
    log(f"{0:5d}    {res.err_Rp:.2e}    {res.err_Rd:.2e}    "
        f"{res.primal_obj:+.6e}    {res.dual_obj:+.6e}    "
        f"{res.rel_gap:.2e}    {sigma:.2e}      {elapsed():.2f}")
    milestones(res, 0, elapsed())
    if res.kkt < params.stop_tol:
        return finish("OPTIMAL", 0, res, sigma, 0)

    restarts = 0
    best_kkt = res.kkt
    best_kkt_it = 0
    while True:
        # Chunks per call: one when verbose (per-checkpoint printing), else
        # up to 128; time limits are checked between calls.
        n_chunks = 1 if params.verbose else 128
        n_chunks = max(1, min(n_chunks,
                              (params.max_iter - it + check - 1) // check))

        t_disp = time.perf_counter()
        (state, rd, sigma_dev, lam_dev, metrics_prev, stacked, k_done,
         best_pt) = run_superchunk(lp, scal, state, rd, sigma_dev, lam_dev,
                                   metrics_prev, it, obj_c_dev,
                                   params.stop_tol, n_chunks, check,
                                   stall_patience, best_pt, graph)
        t_done = time.perf_counter()

        for k in range(k_done):
            it += check
            # Time attribution within the call: linear interpolation.
            t_k = (t_disp - t_alg) + (t_done - t_disp) * (k + 1) / k_done
            m_k = {key: stacked[key][k] for key in stacked}
            res = host_res(m_k, it)
            sigma = float(stacked["sigma"][k])
            restarts += int(stacked["flag"][k])
            stall_events += int(stacked["stall"][k])
            milestones(res, it, t_k)
            if params.verbose and (it % _print_step(it) == 0
                                   or res.kkt < params.stop_tol):
                log(f"{it:5d}    {res.err_Rp:.2e}    {res.err_Rd:.2e}    "
                    f"{res.primal_obj:+.6e}    {res.dual_obj:+.6e}    "
                    f"{res.rel_gap:.2e}    {sigma:.2e}      {t_k:.2f}")

        # Stopping uses the LAST chunk's state (what `state` holds).
        if res.kkt < params.stop_tol:
            return finish("OPTIMAL", it, res, sigma, restarts)
        if it >= params.max_iter:
            return finish("ITER_LIMIT", it, res, sigma, restarts)
        if elapsed() > params.time_limit:
            return finish("TIME_LIMIT", it, res, sigma, restarts)
        if params.stall_window is not None:
            if res.kkt < 0.9 * best_kkt:
                best_kkt, best_kkt_it = res.kkt, it
            elif it - best_kkt_it > params.stall_window:
                return finish("STALLED", it, res, sigma, restarts)


solve_problem.capture_time = None
