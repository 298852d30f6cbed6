"""Mixed-precision solve (precision="mixed"): f32 stages + f64 host
stitching + a warm-started f64 tail for the final stretch.

Port of hprlp_tpu/solver/refine.py, kept line for line; every stage and
tail solve runs on `device`.  The scheme:

1. Solve in f32 with stall detection (the f32 iterates plateau at their
   round-off floor, typically 1e-5..1e-6 true KKT).
2. Zoomed refinement stages: re-solve
       min  c'd   s.t.  zeta(AL - Ax0) <= A d <= zeta(AU - Ax0),
                        zeta(l - x0)  <=  d  <= zeta(u - x0)
   in f32 and stitch x += d/zeta, (y, z) = (yd, zd) in f64 (the cost is
   UNSCALED, so the sub's duals are original-scale duals).  Each stage
   improves the true f64-measured KKT until the f32 measurement floor
   binds (~1e-6).
3. If the target is below what stages can certify, finish with an f64
   solve WARM-STARTED at the refined point, falling back to a cold f64
   solve when the warm tail stalls.

On the card the f32 stages run the tiled SpMV's float build and the f64
tail its double build (csrc/spmv_tiled.cu).  refine_stage_precision="f64"
runs native f64 stages: the port has no double-f32 pairs.  Each stage is
a whole solve_problem call (upload, scaling, graph capture included), as
in the JAX package.

Under a mesh (Parameters.mesh_shape, inside the group) every stage and
the tail are mesh solves, each with its own share ingest.  Every host
decision reads replicated values: the stages' Results, which every rank
returns bitwise alike, host f64 arithmetic on them, and the wall clock,
which is the slowest rank's (`wall`), so every rank takes the same time
budget and the same branch.
"""

from __future__ import annotations

import copy
import time

import numpy as np

from ..parallel import distributed
from ..params import Parameters
from ..problem import LpProblem
from ..results import Results

# f32 stages cannot certify much below this; below it the f64 tail runs.
F32_CERT_FLOOR = 3e-7


def _param_backend(ran: str) -> str:
    """The spmv_backend parameter that runs the backend a solve reports:
    Results.spmv_backend names the tiled kernel "tiled", and its parameter
    value is "lane"."""
    return "lane" if ran == "tiled" else ran


def _project_duals(problem: LpProblem, A, y, z):
    """Clamp multipliers on infinite bounds (they send the dual objective
    to -inf; the reference's postsolve validator projects the same way,
    src/pslp_integration.cpp:499-580).  The y-residue is absorbed into z
    to preserve stationarity c - A'y - z."""
    y_proj = y.copy()
    y_proj[np.isinf(problem.AL) & (y_proj > 0)] = 0.0
    y_proj[np.isinf(problem.AU) & (y_proj < 0)] = 0.0
    if not np.array_equal(y_proj, y):
        z = z + A.T @ (y - y_proj)
        y = y_proj
    z = z.copy()
    z[np.isinf(problem.l) & (z > 0)] = 0.0
    z[np.isinf(problem.u) & (z < 0)] = 0.0
    return y, z


def solve_refined(problem: LpProblem, params: Parameters,
                  x0=None, y0=None, device=None) -> Results:
    """Solve to params.stop_tol by f32 stages and an f64 tail, the KKT
    error measured in host f64.  device: a torch device, None for
    cuda:{params.device_number}."""
    from .loop import solve_problem

    import os as _os
    import sys as _sys

    target = params.stop_tol
    t_start = time.perf_counter()

    def wall() -> float:
        """Seconds since the start; under a mesh the slowest rank's, so
        that every rank takes the same budget and the same branch."""
        t = time.perf_counter() - t_start
        if params.mesh_shape:
            t = distributed.all_ranks_max([t], device)[0]
        return t

    # HPRLP_REFINE_LOG=1: stage lines even on quiet solves (stderr).  Under
    # a mesh only rank 0 prints.
    if params.mesh_shape and distributed.rank() != 0:
        log = lambda *a, **k: None
    elif params.verbose:
        log = print
    elif _os.environ.get("HPRLP_REFINE_LOG"):
        log = lambda *a, **k: print(*a, file=_sys.stderr, flush=True, **k)
    else:
        log = lambda *a, **k: None

    f64_stages = params.refine_stage_precision == "f64"
    stage_params = copy.copy(params)
    stage_params.precision = "f64" if f64_stages else "f32"
    stage_params.use_presolve = False  # applied upstream by the caller
    if f64_stages:
        # f64 stages aim straight at the target: well-behaved instances
        # finish in stage 0 exactly like a direct f64 solve; degenerate
        # ones plateau and hand over to a zoomed stage.  The stall window
        # must outlast the slow marginal new-bests of such a plateau.
        stage_params.stop_tol = target
        if stage_params.stall_window is None:
            stage_params.stall_window = max(9000, 60 * params.check_iter)
        stage_params.max_iter = min(params.max_iter, 75_000)
    else:
        stage_params.stop_tol = max(params.refine_stage_tol, target)
        # A stage that plateaus at its f32 round-off floor should hand
        # over to the next refinement stage, not run to ITER_LIMIT.
        if stage_params.stall_window is None:
            stage_params.stall_window = max(3000, 20 * params.check_iter)

    A = problem.A
    x = np.zeros(problem.n)
    y = np.zeros(problem.m)
    z = np.zeros(problem.n)

    out = Results()
    best = None  # (kkt, x, y, z, metrics)
    total_iter = 0
    # Algorithm clock: the sum of the stages' and the tail's own solve
    # clocks (each excludes setup, scaling, autotune, power method and the
    # graph's capture), so that refined solves stay comparable to direct
    # ones.  Wall time still governs the time budget.
    alg_time = 0.0
    restarts = 0
    retries = 0  # consecutive regressed f64 stages (zoom damping)
    last_sub_sigma = 0.0
    first = {1e-4: True, 1e-6: True, 1e-8: True}
    res = None

    def note_milestones(kkt, t_now):
        for tol, (ai, at) in ((1e-4, ("iter4", "time4")),
                              (1e-6, ("iter6", "time6")),
                              (1e-8, ("iter8", "time8"))):
            if first[tol] and kkt < tol:
                setattr(out, ai, total_iter)
                setattr(out, at, t_now)
                first[tol] = False

    for stage in range(max(1, params.refine_max_stages)):
        budget = params.time_limit - wall()
        if budget <= 0:
            break
        stage_params.time_limit = budget

        if stage == 0:
            res = solve_problem(problem, stage_params, x0=x0, y0=y0,
                                device=device)
            if res.x is None:
                return res  # ERROR surface unchanged
            x, y, z = res.x, res.y, res.z
            sigma_main = res.sigma_final  # same problem/scaling as the tail
            zoom = 1.0
        else:
            kkt_prev = best[0]
            # retries > 0: a previous stage at full zoom REGRESSED -- the
            # incumbent was restored below; damp the zoom exponent (sqrt,
            # then 4th root) so the gentler sub stays solvable.
            zoom = min(params.refine_zoom_cap,
                       max(1.0, (0.1 / max(kkt_prev, 1e-300))
                           ** (0.5 ** retries)))
            Ax = A @ x
            sub = LpProblem.from_arrays(
                A,
                zoom * (problem.AL - Ax), zoom * (problem.AU - Ax),
                zoom * (problem.l - x), zoom * (problem.u - x),
                problem.c)
            # f64 stages warm-start the sub's DUAL at the incumbent y: the
            # sub shares the parent's dual geometry (cost unchanged).
            # Retries must change something material: the scaling
            # normalises the zoom away, so a re-zoomed sub alone re-solves
            # bit-identically.  Retry 1 resumes the regressed sub's adapted
            # sigma; retry 2 goes cold-dual.
            y0_stage = y if f64_stages else None
            sig0 = None
            if f64_stages and retries == 1 and last_sub_sigma:
                sig0 = last_sub_sigma
            elif f64_stages and retries >= 2:
                y0_stage = None
            res = solve_problem(sub, stage_params, y0=y0_stage,
                                sigma0=sig0, device=device)
            last_sub_sigma = res.sigma_final
            if res.x is None or res.status == "ERROR":
                break
            x = np.clip(x + res.x / zoom, problem.l, problem.u)
            # Cost unscaled => the sub's duals are original-scale duals.
            y, z = res.y, res.z
        # Reuse the tuned backend for later stages (same matrix).
        if res.spmv_backend and stage_params.spmv_backend == "auto":
            stage_params.spmv_backend = _param_backend(res.spmv_backend)
        total_iter += res.iter
        restarts += res.restarts
        alg_time += res.time
        out.setup_time += res.setup_time
        out.scaling_time += res.scaling_time
        out.power_time += res.power_time
        out.autotune_time += res.autotune_time

        if f64_stages:
            # Host-exact dual repair: at optimality stationarity defines z
            # given y (z = c - A'y); recomputing it in host f64 zeroes
            # err_Rd at the cost of an O(err_Rd) complementarity shift
            # that the gap term absorbs.
            z = problem.c - A.T @ y
        y, z = _project_duals(problem, A, y, z)
        metrics = problem.kkt_error(x, y, z)
        kkt = metrics["kkt"]
        log(f"[refine] stage {stage}: zoom={zoom:.1e} "
            f"stage_iter={res.iter} kkt={kkt:.3e} "
            f"(Rp={metrics['err_Rp']:.1e} Rd={metrics['err_Rd']:.1e} "
            f"gap={metrics['rel_gap']:.1e})")
        note_milestones(kkt, alg_time)

        # f64 stages taper more gently near the dual floor -- keep zooming
        # while a stage still buys >= 10% (the f32 stages keep the stricter
        # 2x bar: their stages are much costlier relative to progress).
        stall_factor = 0.9 if f64_stages else 0.5
        stalled = (best is not None and stage > 0
                   and kkt > stall_factor * best[0])
        if best is None or kkt < best[0]:
            best = (kkt, x.copy(), y.copy(), z.copy(), metrics)
            retries = 0
        if kkt < target:
            break
        if stalled and f64_stages and retries < 2:
            # Restore the incumbent (the regressed point must not seed the
            # next sub's residuals) and retry at a damped zoom.
            retries += 1
            _, x, y, z, _ = best
            x, y, z = x.copy(), y.copy(), z.copy()
            continue
        if stalled:
            break
        if not f64_stages and best[0] < F32_CERT_FLOOR:
            break  # below what f32 stages can certify; tail decides

    if best is None:
        # Time budget expired before the first stage finished.
        out.status = "TIME_LIMIT" if res is None else res.status
        out.time = alg_time
        if res is not None and res.x is not None:
            out.x, out.y, out.z = res.x, res.y, res.z
            out.iter = res.iter
            out.residuals = res.residuals
            out.primal_obj = res.primal_obj
            out.dual_obj = res.dual_obj
            out.gap = res.gap
        return out

    def terminal_status(last_status):
        """Status when the TARGET tolerance was not met: a stage's own
        OPTIMAL (it only certifies the stage tolerance) must not leak to
        the caller as OPTIMAL-at-target."""
        if wall() >= params.time_limit:
            return "TIME_LIMIT"
        if last_status in ("OPTIMAL", "STALLED"):
            return "STALLED"
        return last_status  # ITER_LIMIT / TIME_LIMIT / ERROR

    kkt, x, y, z, metrics = best
    status = "OPTIMAL" if kkt < target else terminal_status(res.status)

    if kkt >= target and not f64_stages:
        # f64 tail.  Attempt 1 warm-starts at the refined point with the
        # stage's sigma -- on well-behaved instances the tail then needs a
        # few hundred iterations.  On degenerate instances the warm start
        # can stall, so the warm attempt runs with stall detection and a
        # stalled or failed tail falls back to a COLD f64 solve.
        tail_params = copy.copy(params)
        tail_params.precision = "f64"
        tail_params.use_presolve = False
        # A PRODUCTIVE warm tail converges within a few hundred iterations;
        # a tail that has made no new best for 10 checkpoints is the
        # degenerate-stall case and should fall back to cold.
        tail_params.stall_window = max(1500, 10 * params.check_iter)
        # Reuse the stage's tuned backend instead of probing again.
        if stage_params.spmv_backend != "auto":
            tail_params.spmv_backend = stage_params.spmv_backend
        for attempt, (xw, yw) in enumerate(((x, y), (None, None))):
            budget = params.time_limit - wall()
            if budget <= 0:
                break
            tail_params.time_limit = budget
            if attempt == 1:
                tail_params.stall_window = None
            log(f"[refine] f64 tail ({'warm' if attempt == 0 else 'cold'})"
                f" from kkt={kkt:.3e}")
            res_t = solve_problem(problem, tail_params, x0=xw, y0=yw,
                                  sigma0=sigma_main or None, device=device)
            if res_t.x is None:
                break
            total_iter += res_t.iter
            restarts += res_t.restarts
            alg_time += res_t.time
            yt, zt = _project_duals(problem, A, res_t.y, res_t.z)
            mt = problem.kkt_error(res_t.x, yt, zt)
            note_milestones(mt["kkt"], alg_time)
            if mt["kkt"] < kkt:
                kkt, x, y, z, metrics = (mt["kkt"], res_t.x, yt, zt, mt)
            status = ("OPTIMAL" if kkt < target
                      else terminal_status(res_t.status))
            if kkt < target:
                break

    out.status = status
    out.iter = total_iter
    out.time = alg_time
    out.x, out.y, out.z = x, y, z
    out.primal_obj = metrics["primal_obj"]
    out.dual_obj = metrics["dual_obj"]
    out.gap = metrics["rel_gap"]
    out.residuals = kkt
    out.spmv_backend = res.spmv_backend if res is not None else ""
    out.restarts = restarts
    if res is not None:
        out.setup_time = res.setup_time
        out.scaling_time = res.scaling_time
        out.power_time = res.power_time
        out.autotune_time = res.autotune_time
    return out
