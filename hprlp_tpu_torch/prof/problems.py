"""Seeded LP generators of the repository's benchmarks, for the port's
smoke run and variant studies.  Each is a copy of its original, pinned to
it by tests/test_torch_copies.py:

  random_lp, assignment_problem   benchmarks/run.py
  make_problem (M, N, NNZ_PER_ROW, SEED)   bench.py:44-46, 69-82
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..problem import LpProblem

# The bench LP (bench.py): 65536 x 131072, 20 entries per row, seed 0.
M, N = 65536, 131072
NNZ_PER_ROW, SEED = 20, 0


def random_lp(m, n, nnz_per_row, seed=0, name=""):
    """Copy of benchmarks/run.py::random_lp."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), nnz_per_row)
    cols = rng.integers(0, n, size=m * nnz_per_row)
    vals = rng.normal(size=m * nnz_per_row)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    x_feas = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x_feas
    return LpProblem.from_arrays(A, Ax - 1.0, Ax + 1.0, x_feas - 2.0,
                                 x_feas + 2.0, rng.normal(size=n),
                                 name=name or f"random{m}x{n}")


def assignment_problem(n=64, seed=0):
    """Copy of benchmarks/run.py::assignment_problem: LP relaxation of an
    n x n assignment problem."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0.0, 1.0, (n, n))
    rows, cols, vals = [], [], []
    for i in range(n):          # row-sum constraints
        for j in range(n):
            rows.append(i)
            cols.append(i * n + j)
            vals.append(1.0)
    for j in range(n):          # col-sum constraints
        for i in range(n):
            rows.append(n + j)
            cols.append(i * n + j)
            vals.append(1.0)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(2 * n, n * n)).tocsr()
    ones = np.ones(2 * n)
    return LpProblem.from_arrays(A, ones, ones, np.zeros(n * n),
                                 np.ones(n * n), cost.ravel(),
                                 name=f"assignment{n}")


def make_problem():
    """Copy of bench.py::make_problem: the bench LP."""
    rng = np.random.default_rng(SEED)
    rows = np.repeat(np.arange(M), NNZ_PER_ROW)
    cols = rng.integers(0, N, size=M * NNZ_PER_ROW)
    vals = rng.normal(size=M * NNZ_PER_ROW)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(M, N)).tocsr()
    A.sum_duplicates()
    x_feas = rng.uniform(-1.0, 1.0, N)
    Ax = A @ x_feas
    return LpProblem.from_arrays(
        A, Ax - 1.0, Ax + 1.0, x_feas - 2.0, x_feas + 2.0,
        rng.normal(size=N))
