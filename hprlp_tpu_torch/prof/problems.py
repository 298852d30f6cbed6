"""Seeded LP generators of the repository's benchmarks, for the port's
smoke run and variant studies.  Each is a copy of its original, pinned to
it by tests/test_torch_copies.py:

  random_lp, banded_lp, assignment_problem   benchmarks/run.py
  make_problem (M, N, NNZ_PER_ROW, SEED)   bench.py:44-46, 69-82
  structured_lp   benchmarks/prof_presolve_scale.py (the presolvable LP
                  of benchmarks/report_presolve_scale.json)
  batched_lp      benchmarks/run.py::run_batched's generator (295-305)

and `write_mps`, which writes a problem as a free-format MPS file.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..problem import LpProblem

INF = float("inf")

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


def banded_lp(m, n, nnz_per_row, halfwidth, seed=0, name=""):
    """Copy of benchmarks/run.py::banded_lp: a random LP whose row i has
    its columns within +-halfwidth of its diagonal position, the locality
    of giant network and staircase models.  banded_lp(1572864, 3145728,
    72, 16384, 5) is the repository's banded giant (~113M nnz)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), nnz_per_row)
    center = (rows * (n / m)).astype(np.int64)
    cols = (center + rng.integers(-halfwidth, halfwidth + 1,
                                  size=m * nnz_per_row)) % n
    vals = rng.normal(size=m * nnz_per_row)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    x_feas = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x_feas
    return LpProblem.from_arrays(A, Ax - 1.0, Ax + 1.0, x_feas - 2.0,
                                 x_feas + 2.0, rng.normal(size=n),
                                 name=name or f"banded{m}x{n}")


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


def batched_lp(m, n, B, seed):
    """Copy of benchmarks/run.py::run_batched's generator: B members that
    share a random A (~20 entries per row), each feasible around its own
    point.  Returns (A, C, AL, AU, l, u), C, l, u of shape (n, B) and AL,
    AU of shape (m, B), as solve_batched takes them."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=min(0.3, 20.0 / n), random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x0 = rng.uniform(-1, 1, size=(n, B))
    Ax = A @ x0
    return (A, rng.normal(size=(n, B)), Ax - 1.0, Ax + 1.0, x0 - 2.0,
            x0 + 2.0)


def structured_lp(scale: float = 1.0, seed: int = 7) -> LpProblem:
    """A production-planning-shaped LP with deliberately presolvable
    structure at ~10.6M nnz (scale=1):

    - core block: E dense-ish equality/inequality rows x ~18 nnz (the
      irreducible bulk),
    - S singleton capacity rows (singleton-row explorer),
    - D doubleton equalities chaining consecutive variables (doubleton
      substitution),
    - P parallel duplicates of core rows with a scalar multiple
      (parallel-row explorer),
    - F fixed columns (l == u) scattered through the core (fixed-col),
    - empty + implied-free singleton columns at the tail.
    """
    rng = np.random.default_rng(seed)
    E = int(500_000 * scale)   # core rows
    d = 18                     # nnz per core row
    S = int(200_000 * scale)   # singleton rows
    D = int(200_000 * scale)   # doubleton equality rows
    P = int(50_000 * scale)    # parallel duplicate rows
    F = int(50_000 * scale)    # fixed columns
    # Disjoint column ranges keep the instance FEASIBLE by construction:
    # core/singleton/fixed structure lives in [0, n_core); doubleton
    # equalities get dedicated column pairs in [n_core, n) so a fixed
    # column can never contradict an equality chain.
    n_core = int(600_000 * scale)
    n = n_core + 2 * D

    rows = []
    cols = []
    vals = []
    AL = []
    AU = []

    # Core block: rows 0..E-1, random columns, two-sided ranges.
    core_cols = rng.integers(0, n_core, size=(E, d), dtype=np.int64)
    core_vals = rng.uniform(-2.0, 2.0, size=(E, d))
    core_vals[np.abs(core_vals) < 0.1] = 0.5
    rows.append(np.repeat(np.arange(E, dtype=np.int64), d))
    cols.append(core_cols.ravel())
    vals.append(core_vals.ravel())
    lo = rng.uniform(-5.0, 0.0, size=E)
    AL.append(lo)
    AU.append(lo + rng.uniform(0.0, 10.0, size=E))

    # Singleton rows: one entry each on a random core column => becomes a
    # bound.  AU >= 2.5 so even a fixed column (|val*fv| <= 2) satisfies it.
    r0 = E
    scols = rng.integers(0, n_core, size=S, dtype=np.int64)
    rows.append(np.arange(r0, r0 + S, dtype=np.int64))
    cols.append(scols)
    vals.append(rng.uniform(0.5, 2.0, size=S))
    AL.append(np.full(S, -INF))
    AU.append(rng.uniform(2.5, 8.0, size=S))

    # Doubleton equalities over dedicated column pairs (never fixed).
    r0 += S
    base = n_core + 2 * np.arange(D, dtype=np.int64)
    rows.append(np.repeat(np.arange(r0, r0 + D, dtype=np.int64), 2))
    dcols = np.stack([base, base + 1], axis=1).ravel()
    cols.append(dcols)
    dvals = np.stack([np.ones(D), -rng.uniform(0.5, 1.5, size=D)],
                     axis=1).ravel()
    vals.append(dvals)
    beq = rng.uniform(-1.0, 1.0, size=D)
    AL.append(beq)
    AU.append(beq.copy())

    # Parallel rows: duplicates of the first P core rows scaled by alpha.
    r0 += D
    alpha = 2.0
    rows.append(np.repeat(np.arange(r0, r0 + P, dtype=np.int64), d))
    cols.append(core_cols[:P].ravel())
    vals.append(alpha * core_vals[:P].ravel())
    AL.append(alpha * lo[:P])
    AU.append(alpha * (lo[:P] + 3.0))   # tighter than the original

    m = r0 + P
    A = sp.csr_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(m, n))
    A.sum_duplicates()

    l = np.full(n, -10.0)
    u = np.full(n, 10.0)
    fixed = rng.choice(n_core, size=F, replace=False)
    fv = rng.uniform(-1.0, 1.0, size=F)
    l[fixed] = fv
    u[fixed] = fv
    c = rng.uniform(-1.0, 1.0, size=n)

    return LpProblem(A=A, AL=np.concatenate(AL), AU=np.concatenate(AU),
                     l=l, u=u, c=c, name="presolve_scale")


def _exact_range(base, target, sign):
    """r > 0 with base + sign * r == target in floating point, where one
    exists near target - base; else the nearest found (within an ulp or
    two of target)."""
    r = sign * (target - base)
    for _ in range(8):
        got = base + sign * r
        bad = got != target
        if not bad.any():
            break
        up = (got < target) == (sign > 0)
        r[bad] = np.nextafter(r[bad], np.where(up[bad], np.inf, -np.inf))
    return r


def _write_lines(f, lines) -> None:
    if len(lines):
        f.write("\n".join(lines))
        f.write("\n")


def write_mps(problem: LpProblem, path: str, block: int = 1 << 18) -> None:
    """Write `problem` as a free-format MPS file (rows R<i>, columns C<j>,
    objective COST), `block` columns at a time.  Both readers read it back
    to the same LpProblem: every number is written in its shortest
    round-trip form, every column has an objective entry, and a two-sided
    row is written as a G row with a range (L where |AU| < |AL|) chosen so
    that the reader's rhs + range gives the other bound exactly.  Where no
    range can give it exactly (some rows whose bounds straddle zero), the
    bound read back is the nearest a range gives, within two ulps.  A row
    free on both sides is an L row with rhs 1e30, which the readers read
    as +inf."""
    A = problem.A.tocsc()
    A.sort_indices()
    m, n = A.shape
    AL = np.asarray(problem.AL, np.float64)
    AU = np.asarray(problem.AU, np.float64)
    l = np.asarray(problem.l, np.float64)
    u = np.asarray(problem.u, np.float64)
    c = np.asarray(problem.c, np.float64)
    obj_constant = float(problem.obj_constant)
    if problem.objective_sense == -1:  # the readers negate c back
        c, obj_constant = -c, -obj_constant

    eq = AL == AU
    lo_inf, hi_inf = np.isneginf(AL), np.isposinf(AU)
    two = ~eq & ~lo_inf & ~hi_inf
    as_g = (~eq & ~lo_inf & hi_inf) | (two & (np.abs(AL) <= np.abs(AU)))
    rtype = np.where(eq, "E", np.where(as_g, "G", "L"))
    rhs = np.where(eq | as_g, AL, np.where(hi_inf, 1e30, AU))
    rng_val = np.zeros(m)
    g2, l2 = two & as_g, two & ~as_g
    rng_val[g2] = _exact_range(AL[g2], AU[g2], +1)
    rng_val[l2] = _exact_range(AU[l2], AL[l2], -1)

    with open(path, "w") as f:
        f.write(f"NAME {problem.name or 'LP'}\n")
        if problem.objective_sense == -1:
            f.write("OBJSENSE\n    MAX\n")
        f.write("ROWS\n N  COST\n")
        _write_lines(f, [f" {t}  R{i}" for i, t in enumerate(rtype.tolist())])

        f.write("COLUMNS\n")
        indptr, indices, data = A.indptr, A.indices, A.data
        for a in range(0, n, block):
            b = min(n, a + block)
            k0, k1 = int(indptr[a]), int(indptr[b])
            # Each column's objective line, then its entries.
            counts = np.diff(indptr[a:b + 1])
            cols = np.repeat(np.arange(a, b), counts)
            lines = np.empty(k1 - k0 + b - a, dtype=object)
            obj_pos = indptr[a:b] - k0 + np.arange(b - a)
            ent_pos = np.arange(k1 - k0) + (cols - a) + 1
            lines[obj_pos] = [f"    C{j}  COST  {v!r}" for j, v in
                              zip(range(a, b), c[a:b].tolist())]
            lines[ent_pos] = [f"    C{j}  R{i}  {v!r}" for j, i, v in
                              zip(cols.tolist(), indices[k0:k1].tolist(),
                                  data[k0:k1].tolist())]
            _write_lines(f, lines.tolist())

        f.write("RHS\n")
        if obj_constant != 0.0:
            f.write(f"    RHS  COST  {-obj_constant!r}\n")
        nz = np.flatnonzero(rhs != 0.0)
        _write_lines(f, [f"    RHS  R{i}  {v!r}" for i, v in
                         zip(nz.tolist(), rhs[nz].tolist())])
        ranged = np.flatnonzero(two)
        if ranged.size:
            f.write("RANGES\n")
            _write_lines(f, [f"    RNG  R{i}  {v!r}" for i, v in
                             zip(ranged.tolist(), rng_val[ranged].tolist())])

        f.write("BOUNDS\n")
        fixed = l == u
        free = np.isneginf(l) & np.isposinf(u)
        rest = ~fixed & ~free
        cards = (("FX", fixed, l), ("FR", free, None),
                 ("MI", rest & np.isneginf(l), None),
                 ("LO", rest & np.isfinite(l) & ((l != 0.0) | (u < 0.0)), l),
                 ("UP", rest & np.isfinite(u), u))
        for card, mask, val in cards:
            idx = np.flatnonzero(mask)
            if val is None:
                _write_lines(f, [f" {card} BND  C{j}" for j in idx.tolist()])
            else:
                _write_lines(f, [f" {card} BND  C{j}  {v!r}" for j, v in
                                 zip(idx.tolist(), val[idx].tolist())])
        f.write("ENDATA\n")
