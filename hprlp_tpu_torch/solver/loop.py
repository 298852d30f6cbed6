"""Host orchestration of the solve (parity: HPRLP_main_solve, reference:
src/HPRLP.cu:116-310, restart/sigma logic src/main_iterate.cu:312-420).

Port of hprlp_tpu/solver/loop.py.  The pipeline is layout and upload ->
scaling -> SpMV backend (autotune.py) -> power method -> on the card, the
capture of one chunk boundary in a CUDA graph -> restart/sigma/stopping
loop over chunks (device_loop.run_superchunk, replaying the graph) ->
unscale.  Chunk boundaries reproduce the reference's schedule: every
check_iter iterations (restart + stopping).

The layout, upload and scaling are one ingest (`build_ingest`); in the
giant regime (`giant_regime`) it keeps only the SpMV tiles on the device,
and model.py may build it beside presolve and pass it in.

With Parameters(mesh_shape=N) the solve runs on N ranks, one process per
card (parallel/distributed.py): inside a process group of N ranks every
rank runs this solve on its own device with A and A^T column-sharded
(parallel/sharded.py) and the vectors replicated, and returns the same
Results; each rank ingests only its share of the matrix
(build_share_ingest).  Without a group, solve_problem launches the N
ranks and returns rank 0's.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .._malloc import preheat
from ..ops.device_problem import (LpDevice, attach_blocks, canonical_csr,
                                  default_vectors, host_csr, padded_size,
                                  upload_problem)
from ..ops.sparse import spmv_backend
from ..ops.tiles import build_tiles
from ..parallel import distributed
from ..parallel.sharded import (ScalingShare, host_share, shard_from_share,
                                share_cuts, upload_rows)
from ..params import Parameters
from ..problem import LpProblem
from ..results import Results
from .chunk import init_state, initial_metrics, unscale_solution
from .autotune import (AUTOTUNE_LANE_DIRECT_NNZ, autotune_backends,
                       set_spmv_backend)
from .device_loop import capture_superchunk, init_restart_dev, run_superchunk
from .power_iteration import power_method
from .scaling import scale_problem

# On a CUDA device, precision="auto" runs f32 at stop_tol >= this and f64
# below it (the GPU's f64 is native, so "auto" never routes to the
# refinement of precision="mixed").
F64_BELOW_TOL = 1e-5
# At or above this nnz a solve on the tiles keeps the tiles alone
# (giant_regime).  It is the autotune's rule, which owns the number: from
# there on the tiled kernel is taken without a probe, so the CSR arrays
# and the "gather" plan would be kept only to go unused.
GIANT_LANE_FIRST_NNZ = AUTOTUNE_LANE_DIRECT_NNZ
# The giant regime's preheat of the host allocator, as the JAX package's
# giant ingest sizes it (hprlp_tpu/ops/device_problem.py:473-480): ~120
# B/nnz covers the host's CSR, transpose and temporaries, up to 24 GiB.
PREHEAT_B_PER_NNZ = 120
PREHEAT_MAX = 24 << 30
# Results fields on each rank's own clock, which a mesh solve agrees on.
TIME_FIELDS = ("setup_time", "scaling_time", "autotune_time", "power_time",
               "time", "time4", "time6", "time8")


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


def check_mesh_supported(params: Parameters) -> None:
    """Raise NotImplementedError for what a mesh solve does not run yet:
    spmv_backend "gather" or "dense"."""
    if params.mesh_shape and params.spmv_backend in ("gather", "dense"):
        raise NotImplementedError(
            f"mesh_shape with spmv_backend={params.spmv_backend!r} is not "
            f"ported yet (ROADMAP.md queue 1 item 1); a mesh runs the tiled "
            f"kernel: spmv_backend 'auto' or 'lane'")


def mesh_rank_device(params: Parameters, device) -> torch.device:
    """This rank's device in a process group running a mesh of
    params.mesh_shape ranks (distributed.mesh_device), after checking the
    group against the mesh (distributed.check_group)."""
    device = distributed.mesh_device(device)
    distributed.check_group(params.mesh_shape, device)
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def giant_regime(problem: LpProblem, params: Parameters) -> bool:
    """Whether the ingest of `problem` under `params` keeps the tiles
    alone: nnz >= GIANT_LANE_FIRST_NNZ on the tiles ("auto" or "lane"),
    and not precision="mixed", whose stages build their own ingests."""
    return (problem.nnz >= GIANT_LANE_FIRST_NNZ
            and params.spmv_backend in ("auto", "lane")
            and params.precision != "mixed")


def build_ingest(problem: LpProblem, params: Parameters, device=None):
    """The solve's ingest of `problem` under `params` on `device` (None:
    cuda:{params.device_number}).  The matrix crosses the link once and
    never comes back:
      1. "host": A's CSR and A^T's (ops/device_problem.py::host_csr);
      2. "upload": the default layout at the solve's dtype (upload_problem);
      3. "scaling": solver/scaling.py::scale_problem on the device;
      4. "layout": what the SpMV backends read, from the scaled matrices:
         the "gather" plan where that backend may run, and the SpMV tiles
         (ops/tiles.py) where the tiles may.  In the giant regime no plan
         is built and each matrix keeps its tiles alone
         (CsrMatrix.tiles_only), A's CSR arrays released before A^T's
         tiles are built.
    With params.mesh_shape, in a process group of that many ranks, each
    rank runs the share ingest (build_share_ingest) on its device
    (distributed.mesh_device).  In the giant regime the host allocator is
    preheated first (_malloc.preheat, a no-op unless tune_malloc ran).
    Returns (lp, maps, scal, seconds): seconds of the stages above, each
    ended by a device sync, and "wall".  Raises on any failure, and for
    precision="mixed"; no caller tries another route."""
    t0 = time.perf_counter()
    params.validate()
    check_mesh_supported(params)
    if params.precision == "mixed":
        raise ValueError("precision='mixed' solves in stages, each with its "
                         "own ingest: no single ingest")
    if params.mesh_shape:
        device = mesh_rank_device(params, device)
        return build_share_ingest(problem, params, device,
                                  distributed.rank(), params.mesh_shape,
                                  t0=t0)
    device = resolve_device(params, device)
    giant = giant_regime(problem, params)
    if giant:
        preheat(min(problem.nnz * PREHEAT_B_PER_NNZ, PREHEAT_MAX))

    def synced() -> float:
        _sync(device)
        return time.perf_counter()

    A, AT = host_csr(problem)
    t1 = time.perf_counter()
    lp, maps = upload_problem(problem, A, AT,
                              dtype=resolve_dtype(params, device),
                              device=device)
    del A, AT
    t2 = synced()
    lp, scal = scale_problem(lp, use_cr=params.use_CR_scaling,
                             use_ruiz=params.use_Ruiz_scaling,
                             use_pc=params.use_Pock_Chambolle_scaling,
                             use_bc=params.use_bc_scaling)
    t3 = synced()
    if params.spmv_backend in ("auto", "gather") and not giant:
        lp = attach_blocks(lp)
    if params.spmv_backend in ("auto", "lane"):
        # Nothing retiles these tiles, so they keep no CSR order (perm).
        for name in ("A", "AT"):
            M = getattr(lp, name)
            M = M.with_tiles(build_tiles(M).without_perm())
            lp = dataclasses.replace(
                lp, **{name: M.tiles_only() if giant else M})
            del M
    t4 = synced()
    return lp, maps, scal, {"host": t1 - t0, "upload": t2 - t1,
                            "scaling": t3 - t2, "layout": t4 - t3,
                            "wall": t4 - t0}


def build_share_ingest(problem: LpProblem, params: Parameters, device,
                       rank: int, world: int, group=None, t0=None):
    """build_ingest for rank `rank` of a mesh of `world` ranks in `group`
    (None: the default group) on `device`, which holds only the rank's
    share (parallel/sharded.py):
      1. "host": A's canonical CSR, the cuts R and C, and the share's four
         forms (host_share), with no whole transpose;
      2. "upload": the row forms A[R, :] and A^T[C, :] and the replicated
         vectors;
      3. "scaling": scale_problem on the row forms, the ranks' per-row
         results exchanged (ScalingShare: 51 exchanges with every pass
         on);
      4. "layout": the row forms released, the column forms uploaded,
         scaled by the recorded factors and laid out as the tiles of
         A[:, C] and A^T[:, R] (shard_from_share).
    The scaled vectors, factors and tiles are bitwise those of the
    one-card ingest followed by shard_problem.  In the giant regime the
    host allocator is preheated for the share.  After the call
    build_share_ingest.record holds {"rows", "cols", "entries",
    "exchanges"}.  Returns as build_ingest; raises
    on any failure."""
    t0 = time.perf_counter() if t0 is None else t0
    build_share_ingest.record = None
    dtype = resolve_dtype(params, device)

    def synced() -> float:
        _sync(device)
        return time.perf_counter()

    A = canonical_csr(problem)
    m_pad, n_pad = padded_size(problem.m), padded_size(problem.n)
    rows, cols, entries = share_cuts(A, m_pad, n_pad, rank, world)
    if giant_regime(problem, params):
        # The share holds each of its entries in two forms, as the one-card
        # ingest holds A and A^T.
        preheat(min(entries * PREHEAT_B_PER_NNZ // 2, PREHEAT_MAX))
    share = host_share(A, m_pad, n_pad, rows, cols)
    del A
    t1 = time.perf_counter()
    vectors, maps = default_vectors(problem, dtype, device)
    A_rows, AT_rows = upload_rows(share, dtype, device)
    lp = LpDevice(A=A_rows, AT=AT_rows, **vectors)
    del A_rows, AT_rows, vectors
    share.a_rows = share.at_rows = None
    t2 = synced()
    scaling = ScalingShare(a0=share.rows[0], at0=share.cols[0], m=m_pad,
                           n=n_pad, group=group)
    lp, scal = scale_problem(lp, use_cr=params.use_CR_scaling,
                             use_ruiz=params.use_Ruiz_scaling,
                             use_pc=params.use_Pock_Chambolle_scaling,
                             use_bc=params.use_bc_scaling, share=scaling)
    t3 = synced()
    lp = dataclasses.replace(lp, A=None, AT=None)
    A_sh, AT_sh = shard_from_share(share, scaling.passes, dtype, device,
                                   group)
    lp = dataclasses.replace(lp, A=A_sh, AT=AT_sh)
    del A_sh, AT_sh, scaling.passes[:]
    t4 = synced()
    build_share_ingest.record = {
        "rows": share.rows, "cols": share.cols,
        "entries": entries, "exchanges": scaling.exchanges}
    return lp, maps, scal, {"host": t1 - t0, "upload": t2 - t1,
                            "scaling": t3 - t2, "layout": t4 - t3,
                            "wall": t4 - t0}


build_share_ingest.record = None


def solve_problem(problem: LpProblem, params: Parameters | None = None,
                  x0=None, y0=None, sigma0=None, device=None,
                  _ingest=None) -> Results:
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

    The solve builds its ingest (build_ingest), or takes `_ingest`, one
    that model.py built for this problem, params and device beside
    presolve.  setup_time is the ingest's wall less its scaling, and
    scaling_time its scaling.  A failed ingest raises: no other route is
    tried.

    mesh_shape=N ("auto" or "lane"): inside a process group of N ranks,
    each rank solves on its device (distributed.mesh_device: `device`
    "cpu" for gloo ranks, else cuda:{local rank}) with A and A^T
    column-sharded; the decisions come from replicated values and the
    time limit from the slowest rank's clock, so every rank returns the
    same Results, whose times are the ranks' maxima.  Only rank 0 prints.
    Without a group it launches N ranks (_launch_mesh) and returns rank
    0's Results.
    """
    params = params or Parameters()
    params.validate()
    check_mesh_supported(params)
    mesh = bool(params.mesh_shape)
    if mesh and not distributed.in_group():
        return _launch_mesh(problem, params, x0, y0, sigma0, device)
    device = (mesh_rank_device(params, device) if mesh
              else resolve_device(params, device))
    if params.precision == "mixed":
        from .refine import solve_refined

        return solve_refined(problem, params, x0=x0, y0=y0, device=device)
    dtype = resolve_dtype(params, device)
    log = (print if params.verbose and (not mesh or distributed.rank() == 0)
           else (lambda *a, **k: None))

    out = Results()

    solve_problem.capture_time = None
    if _ingest is None:
        _ingest = build_ingest(problem, params, device)
    lp, maps, scal, seconds = _ingest
    del _ingest
    out.setup_time = seconds["wall"] - seconds["scaling"]
    out.scaling_time = seconds["scaling"]
    log(f"Setup (layout and upload) time = {out.setup_time:.2f} seconds")
    scal_host = {k: float(getattr(scal, k)) for k in
                 ("b_scale", "c_scale", "norm_b", "norm_c",
                  "norm_b_org", "norm_c_org")}
    log(f"Scaling time = {out.scaling_time:.2f} seconds")
    if mesh:
        rec = build_share_ingest.record
        log(f"Share ingest: rows {rec['rows']}, columns {rec['cols']}, "
            f"{rec['entries']} entries, {rec['exchanges']} scaling "
            f"exchanges")

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

    def over_time():
        t = elapsed()
        if mesh:  # every rank stops on the same chunk
            t = distributed.all_ranks_max([t], device)[0]
        return t > params.time_limit

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
        if mesh:
            for name, t in zip(TIME_FIELDS, distributed.all_ranks_max(
                    [getattr(out, k) for k in TIME_FIELDS], device)):
                setattr(out, name, t)
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
        if over_time():
            return finish("TIME_LIMIT", it, res, sigma, restarts)
        if params.stall_window is not None:
            if res.kkt < 0.9 * best_kkt:
                best_kkt, best_kkt_it = res.kkt, it
            elif it - best_kkt_it > params.stall_window:
                return finish("STALLED", it, res, sigma, restarts)


solve_problem.capture_time = None


def _launch_mesh(problem, params, x0, y0, sigma0, device) -> Results:
    """solve_problem on params.mesh_shape launched ranks (distributed.
    launch): gloo ranks on the CPU for device "cpu", else NCCL ranks on
    cards 0..N-1.  Returns rank 0's Results."""
    dev_type = distributed.check_launch(params.mesh_shape, device)
    return distributed.launch(
        solve_problem, (problem, params),
        {"x0": x0, "y0": y0, "sigma0": sigma0, "device": dev_type},
        world=params.mesh_shape, device_type=dev_type,
        timeout=params.time_limit + distributed.LAUNCH_SLACK_S)[0]
