"""User-facing Model API (port of hprlp_tpu/model.py: Model, solve,
solve_mps, solve_with_presolve).

`Model.solve` runs presolve -> solve -> postsolve -> original-space KKT
validation, as the JAX package does (use_presolve is on by default).  In
the giant regime (solver/loop.py::giant_regime) it overlaps presolve with
the ingest of the original problem, as the JAX package does, except under
a mesh (Parameters.mesh_shape), where presolve runs first and then the
mesh solve of the reduced problem (solver/loop.py::solve_problem).
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

    In the giant regime with no warm start and no mesh (mesh_shape; the
    overlap is not taken under a mesh: ROADMAP.md queue 1), presolve
    (native, the GIL released) runs in a worker thread while this thread
    builds the ingest of the original problem (solver/loop.py::
    build_ingest).  If presolve removes at most
    REINGEST_SHARE of nnz (or fails), the original is solved on that
    ingest with no postsolve; else the ingest is dropped and the reduced
    problem solved.  A failed ingest raises once the worker has joined.
    """
    params = parameters or Parameters()
    log = print if params.verbose else (lambda *a, **k: None)
    if not params.use_presolve:
        return solve_problem(problem, params, x0=x0, y0=y0, device=device)

    from . import presolve as ps

    # Presolve wall budget: the 60 s default clipped to the solver's time
    # limit.
    pre_budget = min(60.0, float(params.time_limit))
    ingest = None
    if (x0 is None and y0 is None and not params.mesh_shape
            and loop.giant_regime(problem, params)):
        # Both threads start by canonicalising A in place: done here, once,
        # before they share it.
        problem.A.sum_duplicates()
        with ThreadPoolExecutor(1) as pool:
            worker = pool.submit(_presolve, ps, problem, pre_budget)
            # An ingest error leaves the with block, which joins the
            # worker first.
            ingest = loop.build_ingest(problem, params, device)
            status, reduced, handle, t_pre = worker.result()
        if status == "OK" and reduced.n > 0:
            removed = problem.nnz - reduced.nnz
            if removed > REINGEST_SHARE * problem.nnz:
                ingest = None  # frees it before the reduced problem's
            else:
                log(f"Presolve removed {removed} nnz (<= "
                    f"{REINGEST_SHARE:.0%}); solving the original on the "
                    f"ingest built beside it")
                res = solve_problem(problem, params, device=device,
                                    _ingest=ingest)
                res.presolve_time = t_pre
                return res
    else:
        status, reduced, handle, t_pre = _presolve(ps, problem, pre_budget)
        if params.mesh_shape and distributed.in_group():
            # Each rank presolved the same problem; they agree on its time.
            t_pre = distributed.all_ranks_max(
                [t_pre], distributed.mesh_device(device))[0]

    if status in ("INFEASIBLE", "UNBOUNDED"):
        res = Results()
        res.status = status
        res.time = t_pre
        res.presolve_time = t_pre
        log(f"Presolve detected {status} in {t_pre:.2f} seconds")
        return res
    if status != "OK":
        return solve_problem(problem, params, x0=x0, y0=y0, device=device,
                             _ingest=ingest)
    ingest = None

    st = handle.stats()
    log(f"Presolve: {problem.m}x{problem.n} ({problem.nnz} nnz) -> "
        f"{reduced.m}x{reduced.n} ({reduced.nnz} nnz) in "
        f"{st['rounds']} rounds, {t_pre:.2f} seconds")
    if reduced.n == 0:
        # Fully solved by presolve.
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
        return res
    x0_red = y0_red = None
    if x0 is not None or y0 is not None:
        row_map, col_map = handle.maps()
        if x0 is not None:
            x0_red = np.asarray(x0, float)[col_map]
        if y0 is not None:
            y0_red = np.asarray(y0, float)[row_map]
    res = solve_problem(reduced, params, x0=x0_red, y0=y0_red, device=device)
    res.presolve_time = t_pre
    if res.x is not None:
        x, y, z = handle.postsolve(res.x, res.y, res.z)
        res.x, res.y, res.z = x, y, z
        metrics = ps.validate_original_kkt(problem, x, y, z, params.stop_tol,
                                           verbose=params.verbose)
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
