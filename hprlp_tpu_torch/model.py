"""User-facing Model API (port of hprlp_tpu/model.py: Model, solve,
solve_mps, solve_with_presolve).

`Model.solve` runs presolve -> solve -> postsolve -> original-space KKT
validation, as the JAX package does (use_presolve is on by default).  The
JAX package's giant-regime overlap of presolve with the TPU's lane-first
ingest is not carried over.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

from .io.mps import read_mps
from .params import Parameters
from .problem import LpProblem
from .results import Results
from .solver.loop import solve_problem


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


def solve_with_presolve(problem: LpProblem,
                        parameters: Optional[Parameters] = None,
                        x0=None, y0=None, device=None) -> Results:
    """Presolve -> core solve -> postsolve -> original-space KKT validation.

    A presolve failure of any kind falls back to solving the unreduced
    model with a warning.  An original-space warm start (x0, y0) is
    projected onto the reduced problem via the presolver's index maps.
    """
    params = parameters or Parameters()
    log = print if params.verbose else (lambda *a, **k: None)
    if not params.use_presolve:
        return solve_problem(problem, params, x0=x0, y0=y0, device=device)

    from . import presolve as ps

    t0 = time.perf_counter()
    # Presolve wall budget: the 60 s default clipped to the solver's time
    # limit.
    pre_budget = min(60.0, float(params.time_limit))
    try:
        status, reduced, handle = ps.presolve_problem(problem,
                                                      max_time=pre_budget)
    except Exception as e:  # error boundary: degrade to the full model
        print(f"[presolve] failed ({e}); solving the original model",
              file=sys.stderr)
        status, reduced, handle = "UNAVAILABLE", None, None
    t_pre = time.perf_counter() - t0

    if status in ("INFEASIBLE", "UNBOUNDED"):
        res = Results()
        res.status = status
        res.time = t_pre
        res.presolve_time = t_pre
        log(f"Presolve detected {status} in {t_pre:.2f} seconds")
        return res
    if status != "OK":
        return solve_problem(problem, params, x0=x0, y0=y0, device=device)

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
