"""Host-side LP problem container.

The standard form matches the reference solver (reference: README.md:3,
include/HPRLP.h:57-62):

    minimize    c'x + obj_constant
    subject to  AL <= A x <= AU
                l  <=   x <= u

A is a scipy CSR matrix; all vectors are float64 numpy arrays.  Bounds with
magnitude >= NUMERICAL_INFINITY are normalised to +/-inf (reference:
include/constants.h:176).

Copy of hprlp_tpu/problem.py, which cannot be imported without JAX;
tests/test_torch_copies.py pins the two together.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from .constants import NUMERICAL_INFINITY


@dataclasses.dataclass
class LpProblem:
    A: sp.csr_matrix
    AL: np.ndarray
    AU: np.ndarray
    l: np.ndarray
    u: np.ndarray
    c: np.ndarray
    obj_constant: float = 0.0
    # +1 for minimisation, -1 if the original problem was a maximisation
    # that was converted (c negated) to minimisation form.
    objective_sense: int = 1
    name: str = ""

    @property
    def m(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.A.nnz)

    @staticmethod
    def from_arrays(A, AL, AU, l, u, c, obj_constant: float = 0.0,
                    name: str = "", objective_sense: int = 1) -> "LpProblem":
        """Build a problem from a (dense or sparse) matrix and bound arrays.

        Parity surface with create_model_from_arrays (reference:
        src/HPRLP.cu:321-446); accepts CSR/CSC/COO/dense and converts to CSR.
        """
        if sp.issparse(A):
            A = A.tocsr().astype(np.float64)
        else:
            A = sp.csr_matrix(np.asarray(A, dtype=np.float64))
        A.sum_duplicates()
        m, n = A.shape

        def vec(v, size, what):
            v = np.asarray(v, dtype=np.float64).ravel().copy()
            if v.size != size:
                raise ValueError(f"{what} has size {v.size}, expected {size}")
            return v

        AL = _normalize_inf(vec(AL, m, "AL"))
        AU = _normalize_inf(vec(AU, m, "AU"))
        l = _normalize_inf(vec(l, n, "l"))
        u = _normalize_inf(vec(u, n, "u"))
        c = vec(c, n, "c")

        # Data validation (parity: the reference validates arrays on model
        # creation, src/mps_reader.cpp:1397-1510): NaNs anywhere, or
        # non-finite matrix/cost entries, would silently corrupt the
        # solve.
        if A.nnz and not np.all(np.isfinite(A.data)):
            raise ValueError("matrix A contains non-finite entries")
        if not np.all(np.isfinite(c)):
            raise ValueError("cost vector c contains non-finite entries")
        for v, what in ((AL, "AL"), (AU, "AU"), (l, "l"), (u, "u")):
            if np.any(np.isnan(v)):
                raise ValueError(f"{what} contains NaN")

        if np.any(AL > AU):
            raise ValueError("infeasible constraint bounds: AL > AU")
        if np.any(l > u):
            raise ValueError("infeasible variable bounds: l > u")
        # Equal INFINITE bounds pass the orderings above (inf > inf is
        # False) but pin a variable/row AT infinity — presolve would then
        # fix x_j = inf and fold c_j * inf (Inf or 0*inf = NaN) into the
        # objective with no diagnostic.
        if np.any(np.isinf(l) & (l == u)):
            raise ValueError(
                "degenerate variable bounds: l == u == +-inf pins a "
                "variable at infinity")
        if np.any(np.isinf(AL) & (AL == AU)):
            raise ValueError(
                "degenerate constraint bounds: AL == AU == +-inf")

        return LpProblem(A=A, AL=AL, AU=AU, l=l, u=u, c=c,
                         obj_constant=float(obj_constant), name=name,
                         objective_sense=objective_sense)

    def kkt_error(self, x: np.ndarray, y: np.ndarray, z: np.ndarray):
        """Relative KKT error of a candidate solution in original space.

        Matches the reference's stopping measure (src/main_iterate.cu:273-291,
        :406-420): max of relative primal infeasibility, relative dual
        infeasibility, and relative primal-dual gap.  Useful as a
        property-test oracle.
        """
        A = self.A
        Ax = A @ x
        rp = np.maximum(self.AL - Ax, 0.0) + np.maximum(Ax - self.AU, 0.0)
        bviol = np.maximum(self.l - x, 0.0) + np.maximum(x - self.u, 0.0)
        b_conc = _conceptual_b(self.AL, self.AU)
        norm_b = 1.0 + np.linalg.norm(b_conc)
        err_rp = float(np.sqrt(np.linalg.norm(rp) ** 2 + np.linalg.norm(bviol) ** 2) / norm_b)

        rd = self.c - A.T @ y - z
        norm_c = 1.0 + np.linalg.norm(self.c)
        err_rd = float(np.linalg.norm(rd) / norm_c)

        p_obj = float(self.c @ x) + self.obj_constant
        # Dual objective: support terms of the constraint box and variable box.
        d_obj = (_box_support(y, self.AL, self.AU)
                 + _box_support(z, self.l, self.u) + self.obj_constant)
        gap = abs(p_obj - d_obj) / (1.0 + abs(p_obj) + abs(d_obj))
        return {"err_Rp": err_rp, "err_Rd": err_rd, "rel_gap": gap,
                "primal_obj": p_obj, "dual_obj": d_obj,
                "kkt": max(err_rp, err_rd, gap)}


def _normalize_inf(v: np.ndarray) -> np.ndarray:
    v = v.copy()
    v[v >= NUMERICAL_INFINITY] = np.inf
    v[v <= -NUMERICAL_INFINITY] = -np.inf
    return v


def _conceptual_b(AL: np.ndarray, AU: np.ndarray) -> np.ndarray:
    """max(|AL|, |AU|) with infinities mapped to 0 (reference:
    src/cuda_kernels/HPR_cuda_kernels.cu:34-43)."""
    a = np.where(np.isinf(AL), 0.0, np.abs(AL))
    b = np.where(np.isinf(AU), 0.0, np.abs(AU))
    return np.maximum(a, b)


def _box_support(w: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> float:
    """sum_i [w_i > 0] w_i*lo_i + [w_i < 0] w_i*hi_i, with 0*inf -> 0.

    This is the concave conjugate term <w, proj>(box) used in the dual
    objective of the boxed-constraint LP.
    """
    pos = np.where(w > 0, w * np.where(np.isinf(lo), 0.0, lo), 0.0)
    neg = np.where(w < 0, w * np.where(np.isinf(hi), 0.0, hi), 0.0)
    # Positive multiplier on an infinite bound means -inf dual value; report
    # a very negative number rather than nan.
    bad = np.any((w > 1e-12) & np.isinf(lo)) or np.any((w < -1e-12) & np.isinf(hi))
    val = float(np.sum(pos + neg))
    return -np.inf if bad else val
