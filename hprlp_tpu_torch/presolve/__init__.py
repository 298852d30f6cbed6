"""Presolve: native C++ reductions with typed postsolve.

Port of hprlp_tpu/presolve/__init__.py.  The reductions run in-process in
the host library (native.py) behind the reference's error boundary: any
failure falls back to solving the unreduced model with a warning
(model.solve_with_presolve).
"""

from __future__ import annotations

import ctypes as ct
import sys

import numpy as np
import scipy.sparse as sp

from ..native import get_lib
from ..problem import LpProblem


class PresolveHandle:
    """Owns the native presolver handle for later postsolve."""

    def __init__(self, lib, ptr, m_orig: int, n_orig: int):
        self._lib = lib
        self._ptr = ptr
        self.m_orig = m_orig
        self.n_orig = n_orig
        # Reduced dimensions the native postsolve reads from its input
        # buffers.  When every column is fixed but rows stay (m > 0,
        # n == 0), callers pass zero-length vectors; postsolve() pads them
        # to these sizes so the native loop never reads out of bounds.
        self.reduced_m = lib.hpres_reduced_m(ptr) if ptr else 0
        self.reduced_n = lib.hpres_reduced_n(ptr) if ptr else 0

    def stats(self) -> dict:
        r = ct.c_int64()
        c = ct.c_int64()
        z = ct.c_int64()
        rd = ct.c_int64()
        self._lib.hpres_stats(self._ptr, ct.byref(r), ct.byref(c),
                              ct.byref(z), ct.byref(rd))
        return {"rows_removed": r.value, "cols_removed": c.value,
                "nnz_removed": z.value, "rounds": rd.value}

    def report(self) -> dict:
        """Per-explorer wall time and tightening counts."""
        buf = ct.create_string_buffer(4096)
        self._lib.hpres_report(self._ptr, buf, len(buf))
        out = {}
        for line in buf.value.decode().splitlines():
            k, v = line.rsplit(" ", 1)
            out[k] = float(v)
        return out

    def maps(self):
        """(row_map, col_map): reduced position -> original index, to
        project an original-space warm start onto the reduced problem
        (x_red = x0[col_map], y_red = y0[row_map])."""
        row_map = np.zeros(self.reduced_m, np.int64)
        col_map = np.zeros(self.reduced_n, np.int64)
        self._lib.hpres_get_maps(self._ptr, row_map, col_map)
        return row_map, col_map

    def postsolve(self, x_red: np.ndarray, y_red: np.ndarray,
                  z_red: np.ndarray):
        """Map a reduced solution back to the original space."""
        def fit(v, size):
            v = np.ascontiguousarray(v, np.float64)
            if v.shape[0] < size:
                v = np.concatenate([v, np.zeros(size - v.shape[0])])
            return v

        x = np.zeros(self.n_orig)
        y = np.zeros(self.m_orig)
        z = np.zeros(self.n_orig)
        self._lib.hpres_postsolve(
            self._ptr, fit(x_red, self.reduced_n), fit(y_red, self.reduced_m),
            fit(z_red, self.reduced_n), x, y, z)
        return x, y, z

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.hpres_free(self._ptr)
            self._ptr = None


def is_available() -> bool:
    return get_lib() is not None


def presolve_problem(problem: LpProblem, feas_tol: float = 1e-8,
                     max_rounds: int = 0, max_time: float = 0.0,
                     debug_checks: bool = False):
    """Run native presolve.

    max_time: wall-clock budget in seconds (<= 0 selects the 60 s default).
    debug_checks: run the invariant checker after every pass; a violation
    fails the presolve and the caller solves the unreduced model.

    Returns (status, reduced LpProblem | None, PresolveHandle | None):
    status is "OK" / "INFEASIBLE" / "UNBOUNDED" / "UNAVAILABLE".
    When status == "OK" and the problem reduced to nothing, the reduced
    problem has n == 0 and the caller can postsolve empty vectors.
    """
    lib = get_lib()
    if lib is None:
        return "UNAVAILABLE", None, None

    A = problem.A.tocsr()
    A.sum_duplicates()
    m, n = A.shape
    ptr = lib.hpres_presolve_ex(
        m, n,
        np.ascontiguousarray(A.indptr, np.int64),
        np.ascontiguousarray(A.indices, np.int32),
        np.ascontiguousarray(A.data, np.float64),
        np.ascontiguousarray(problem.AL, np.float64),
        np.ascontiguousarray(problem.AU, np.float64),
        np.ascontiguousarray(problem.l, np.float64),
        np.ascontiguousarray(problem.u, np.float64),
        np.ascontiguousarray(problem.c, np.float64),
        float(feas_tol), int(max_rounds), float(max_time),
        1 if debug_checks else 0)
    handle = PresolveHandle(lib, ptr, m, n)

    st = lib.hpres_status(ptr)
    if st == 1:
        return "INFEASIBLE", None, handle
    if st == 2:
        return "UNBOUNDED", None, handle
    if st != 0:
        return "UNAVAILABLE", None, None

    rm = lib.hpres_reduced_m(ptr)
    rn = lib.hpres_reduced_n(ptr)
    rz = lib.hpres_reduced_nnz(ptr)
    Ap = np.zeros(rm + 1, np.int64)
    Ai = np.zeros(max(rz, 1), np.int32)
    Ax = np.zeros(max(rz, 1), np.float64)
    AL = np.zeros(max(rm, 1), np.float64)
    AU = np.zeros(max(rm, 1), np.float64)
    l = np.zeros(max(rn, 1), np.float64)
    u = np.zeros(max(rn, 1), np.float64)
    c = np.zeros(max(rn, 1), np.float64)
    lib.hpres_get_reduced(ptr, Ap, Ai, Ax, AL, AU, l, u, c)
    obj_shift = lib.hpres_obj_shift(ptr)

    A_red = sp.csr_matrix((Ax[:rz], Ai[:rz], Ap), shape=(rm, rn))
    reduced = LpProblem(
        A=A_red, AL=AL[:rm], AU=AU[:rm], l=l[:rn], u=u[:rn], c=c[:rn],
        obj_constant=problem.obj_constant + obj_shift,
        objective_sense=problem.objective_sense,
        name=problem.name)
    return "OK", reduced, handle


def validate_original_kkt(problem: LpProblem, x, y, z, tol: float,
                          verbose: bool = True) -> dict:
    """Original-space KKT validation after postsolve: warn, never fail."""
    metrics = problem.kkt_error(x, y, z)
    if verbose and metrics["kkt"] > 10 * tol:
        print(f"[presolve] warning: original-space KKT {metrics['kkt']:.2e} "
              f"exceeds tolerance {tol:.0e} after postsolve "
              f"(primal solution and objective remain reliable)",
              file=sys.stderr)
    return metrics
