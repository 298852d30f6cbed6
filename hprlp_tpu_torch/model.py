"""User-facing Model API (port of hprlp_tpu/model.py: Model, solve,
solve_mps, solve_with_presolve).

`Model.solve` runs presolve -> solve -> postsolve -> original-space KKT
validation, as the JAX package does (use_presolve is on by default).  In
the giant regime (solver/loop.py::giant_regime) it overlaps presolve with
the ingest of the original problem, as the JAX package does.  Under a
mesh (Parameters.mesh_shape) presolve runs once, on rank 0, and every
rank solves what it decided (solve_with_presolve).
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from .io.mps import read_mps
from .parallel import distributed
from .params import Parameters
from .problem import LpProblem
from .results import Results
from .solver import loop
from .solver.loop import solve_problem

# Presolve must remove more than this share of nnz for the ingest of the
# original problem, built beside it, to be dropped for the reduced one.
REINGEST_SHARE = 0.1


class Model:
    """An LP model created from arrays, scipy sparse matrices or MPS
    files."""

    def __init__(self, problem: LpProblem):
        self._problem = problem

    @property
    def problem(self) -> LpProblem:
        return self._problem

    @property
    def m(self) -> int:
        return self._problem.m

    @property
    def n(self) -> int:
        return self._problem.n

    @property
    def nnz(self) -> int:
        return self._problem.nnz

    @classmethod
    def from_arrays(cls, A, AL, AU, l, u, c, obj_constant: float = 0.0
                    ) -> "Model":
        return cls(LpProblem.from_arrays(A, AL, AU, l, u, c, obj_constant))

    @classmethod
    def from_mps(cls, path: str, **kw) -> "Model":
        # The native (C++) reader is the fast path; the pure-Python reader
        # is the golden reference and the fallback without the library.
        from .io import native_mps

        if native_mps.is_available():
            return cls(native_mps.read_mps_native(path, **kw))
        return cls(read_mps(path, **kw))

    def solve(self, parameters: Optional[Parameters] = None, x0=None,
              y0=None, device=None) -> Results:
        """Solve; x0/y0 warm-start in the original space.  With presolve
        on, the point is projected onto the reduced problem through the
        row/column maps.  device: a torch device, None for
        cuda:{parameters.device_number}."""
        res = solve_with_presolve(self._problem, parameters, x0=x0, y0=y0,
                                  device=device)
        return _apply_sense(res, self._problem.objective_sense)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _presolve(ps, problem: LpProblem, budget: float):
    """presolve_problem behind the reference's error boundary: a failure of
    any kind degrades to the unreduced model with a warning.  Returns
    (status, reduced, handle, seconds)."""
    t0 = time.perf_counter()
    try:
        status, reduced, handle = ps.presolve_problem(problem,
                                                      max_time=budget)
    except Exception as e:  # error boundary: degrade to the full model
        print(f"[presolve] failed ({e}); solving the original model",
              file=sys.stderr)
        status, reduced, handle = "UNAVAILABLE", None, None
    return status, reduced, handle, time.perf_counter() - t0


def solve_with_presolve(problem: LpProblem,
                        parameters: Optional[Parameters] = None,
                        x0=None, y0=None, device=None) -> Results:
    """Presolve -> core solve -> postsolve -> original-space KKT validation.

    A presolve failure of any kind falls back to solving the unreduced
    model with a warning.  An original-space warm start (x0, y0) is
    projected onto the reduced problem via the presolver's index maps.

    In the giant regime with no warm start, presolve (native, the GIL
    released) runs in a worker thread while this thread builds the ingest
    of the original problem (solver/loop.py::build_ingest).  If presolve
    removes at most REINGEST_SHARE of nnz (or fails), the original is
    solved on that ingest with no postsolve; else the ingest is dropped
    and the reduced problem solved.  A failed ingest raises once the
    worker has joined.

    With mesh_shape, inside a process group of that many ranks, presolve
    runs once per mesh: rank 0 presolves (in the giant regime beside
    every rank's share ingest of the original) and decides, and
    distributed.broadcast_object gives every rank its outcome: the
    status, the reduced problem where that is what is solved, the
    projected warm start.  The ranks solve on the mesh; rank 0, which
    holds the presolver's handle, postsolves and validates, and its
    original-space x, y, z and metrics are broadcast, so every rank
    returns bitwise the same Results.  Without a group it launches the
    ranks, each running this function (distributed.launch), and returns
    rank 0's Results.  After the call solve_with_presolve.record holds
    {"presolved": whether this process presolved, "broadcast_bytes",
    "broadcast_s": the broadcasts' totals} (None without presolve).
    """
    params = parameters or Parameters()
    solve_with_presolve.record = None
    if not params.use_presolve:
        return solve_problem(problem, params, x0=x0, y0=y0, device=device)
    mesh = bool(params.mesh_shape)
    if mesh and not distributed.in_group():
        return _launch_mesh(problem, params, x0, y0, device)

    from . import presolve as ps

    # The process that presolves: this one, but for a mesh's ranks > 0.
    lead = not mesh or distributed.rank() == 0
    record = {"presolved": lead, "broadcast_bytes": 0, "broadcast_s": 0.0}
    solve_with_presolve.record = record
    log = (print if params.verbose and lead else (lambda *a, **k: None))
    if mesh:
        params.validate()
        loop.check_mesh_supported(params)
        mesh_dev = loop.mesh_rank_device(params, device)

    def from_lead(obj):
        """The lead's obj on every rank of a mesh."""
        if not mesh:
            return obj
        obj = distributed.broadcast_object(obj, mesh_dev)
        record["broadcast_bytes"] += distributed.broadcast_object.record[
            "bytes"]
        record["broadcast_s"] += distributed.broadcast_object.record[
            "seconds"]
        return obj

    # Presolve wall budget: the 60 s default clipped to the solver's time
    # limit.
    pre_budget = min(60.0, float(params.time_limit))
    ingest = None
    overlap = (x0 is None and y0 is None
               and loop.giant_regime(problem, params))
    if overlap:
        # Both threads start by canonicalising A in place: done here, once,
        # before they share it.
        problem.A.sum_duplicates()
        with ThreadPoolExecutor(1) as pool:
            worker = (pool.submit(_presolve, ps, problem, pre_budget)
                      if lead else None)
            # An ingest error leaves the with block, which joins the
            # worker first.
            ingest = loop.build_ingest(problem, params, device)
            outcome = worker.result() if lead else None
    else:
        outcome = _presolve(ps, problem, pre_budget) if lead else None

    handle = decision = None
    if lead:
        status, reduced, handle, t_pre = outcome
        decision = _decide(problem, status, reduced, t_pre, overlap, x0, y0,
                           handle, log)
    del outcome
    what = from_lead(decision[0] if lead else None)
    if what not in ("original", "reuse"):
        # Released before the rest of the outcome (a reduced LP) crosses.
        ingest = None
    what, status, t_pre, reduced, x0_red, y0_red = from_lead(decision)
    del decision

    if what == "stop":
        res = Results()
        res.status = status
        res.time = t_pre
        res.presolve_time = t_pre
        log(f"Presolve detected {status} in {t_pre:.2f} seconds")
        return res
    if what in ("original", "reuse"):
        res = solve_problem(problem, params, x0=x0, y0=y0, device=device,
                            _ingest=ingest)
        if what == "reuse":
            res.presolve_time = t_pre
        return res
    if what == "empty":
        # Fully solved by presolve.
        res = None
        if lead:
            x, y, z = handle.postsolve(np.zeros(0), np.zeros(0), np.zeros(0))
            res = Results()
            metrics = problem.kkt_error(x, y, z)
            res.status = ("OPTIMAL" if metrics["kkt"] < params.stop_tol
                          else "ERROR")
            res.x, res.y, res.z = x, y, z
            res.primal_obj = metrics["primal_obj"]
            res.dual_obj = metrics["dual_obj"]
            res.gap = metrics["rel_gap"]
            res.residuals = metrics["kkt"]
            res.time = t_pre
            res.presolve_time = t_pre
        return from_lead(res)
    res = solve_problem(reduced, params, x0=x0_red, y0=y0_red, device=device)
    res.presolve_time = t_pre
    if res.x is not None:
        post = None
        if lead:
            x, y, z = handle.postsolve(res.x, res.y, res.z)
            metrics = ps.validate_original_kkt(problem, x, y, z,
                                               params.stop_tol,
                                               verbose=params.verbose)
            post = (x, y, z, metrics)
        res.x, res.y, res.z, metrics = from_lead(post)
        res.primal_obj = metrics["primal_obj"]
        res.dual_obj = metrics["dual_obj"]
        res.gap = metrics["rel_gap"]
        res.residuals = metrics["kkt"]
        if (res.status in ("STALLED", "ITER_LIMIT", "TIME_LIMIT")
                and metrics["kkt"] < params.stop_tol):
            # The original-space validation, which the reference certifies
            # against, meets the tolerance though the reduced solve gave
            # up: postsolve rebuilds the eliminated rows and columns
            # exactly, which can repair the binding components.
            res.status = "OPTIMAL"
    return res


solve_with_presolve.record = None


def _decide(problem, status, reduced, t_pre, overlap, x0, y0, handle, log):
    """What the solve does after presolve, decided where it ran: (what,
    status, t_pre, the reduced problem or None, the projected warm
    start).  what: "stop" (presolve found the LP infeasible or
    unbounded), "original" (presolve failed: the original is solved),
    "reuse" (the original is solved on the ingest built beside presolve,
    which removed at most REINGEST_SHARE of nnz), "empty" (presolve solved
    it) or "reduced"."""
    if status in ("INFEASIBLE", "UNBOUNDED"):
        return "stop", status, t_pre, None, None, None
    if status != "OK":
        return "original", status, t_pre, None, None, None
    if overlap and reduced.n > 0:
        removed = problem.nnz - reduced.nnz
        if removed <= REINGEST_SHARE * problem.nnz:
            log(f"Presolve removed {removed} nnz (<= {REINGEST_SHARE:.0%}); "
                f"solving the original on the ingest built beside it")
            return "reuse", status, t_pre, None, None, None
    st = handle.stats()
    log(f"Presolve: {problem.m}x{problem.n} ({problem.nnz} nnz) -> "
        f"{reduced.m}x{reduced.n} ({reduced.nnz} nnz) in "
        f"{st['rounds']} rounds, {t_pre:.2f} seconds")
    if reduced.n == 0:
        return "empty", status, t_pre, None, None, None
    x0_red = y0_red = None
    if x0 is not None or y0 is not None:
        row_map, col_map = handle.maps()
        if x0 is not None:
            x0_red = np.asarray(x0, float)[col_map]
        if y0 is not None:
            y0_red = np.asarray(y0, float)[row_map]
    return "reduced", status, t_pre, reduced, x0_red, y0_red


def _launch_mesh(problem, params, x0, y0, device) -> Results:
    """solve_with_presolve on params.mesh_shape launched ranks
    (distributed.launch), as solver/loop.py launches solve_problem's.
    Returns rank 0's Results."""
    params.validate()
    loop.check_mesh_supported(params)
    dev_type = distributed.check_launch(params.mesh_shape, device)
    return distributed.launch(
        solve_with_presolve, (problem, params),
        {"x0": x0, "y0": y0, "device": dev_type},
        world=params.mesh_shape, device_type=dev_type,
        timeout=params.time_limit + distributed.LAUNCH_SLACK_S)[0]


def solve(A, AL, AU, l, u, c, parameters: Optional[Parameters] = None,
          obj_constant: float = 0.0, device=None) -> Results:
    """One-shot solve from arrays (parity: hprlp.solve)."""
    return Model.from_arrays(A, AL, AU, l, u, c, obj_constant).solve(
        parameters, device=device)


def solve_mps(path: str, parameters: Optional[Parameters] = None,
              device=None, **reader_kw) -> Results:
    """One-shot solve from an MPS file (parity: hprlp.solve_mps)."""
    return Model.from_mps(path, **reader_kw).solve(parameters, device=device)


def _apply_sense(res: Results, sense: int) -> Results:
    """Report objectives in the problem's original sense.  For OBJSENSE MAX
    problems (converted to min internally) the true objective is the
    negation of the minimised one."""
    if sense == -1:
        res.primal_obj = -res.primal_obj
        res.dual_obj = -res.dual_obj
    return res
