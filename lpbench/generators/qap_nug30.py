"""LP relaxation of a quadratic assignment problem of size N, as Resende,
Ramakrishnan and Drezner (Oper. Res. 43, 1995) write it and Mittelmann's LP
test set holds nug30's: the Adams-Johnson linearisation with y_ijkl and
y_klij merged into one column.

Columns: x_ij (facility i at location j) is column i * N + j; the y_ijkl
with i < k and j != l follow, the pair (i, k) major (i, then k), then
(j, l) (j, then l).  Rows, each an equality:

- 0 .. N - 1: sum_j x_ij = 1; N .. 2N - 1: sum_i x_ij = 1;
- for each (i, j) and k != i: sum_{l != j} y_ijkl - x_ij = 0;
- for each (i, j) and l != j: sum_{k != i} y_ijkl - x_ij = 0;

with y_ijkl read as y_klij where i > k.  x, y >= 0 with no upper bounds;
costs f_ik d_jl + f_ki d_lj on y_ijkl and 0 on x.  So m = 2N + 2N^2(N - 1),
n = N^2 + N^2 (N - 1)^2 / 2 and nnz = 2N^2 (N - 1)^2 + 2N^3: every row has
N entries, every y column 4 and every x column 2N.

Distances are Manhattan on the configuration's grid of locations; flows
are symmetric integers uniform on 0 .. 10 with a zero diagonal, drawn on
the generator's device (the card in a run) and handed over as host
arrays, as a caller holds them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def sizes(N: int) -> tuple:
    """(m, n, nnz) of the LP of size N."""
    return (2 * N + 2 * N * N * (N - 1), N * N + N * N * (N - 1) ** 2 // 2,
            2 * N * N * (N - 1) ** 2 + 2 * N ** 3)


def _pairs(N: int):
    """(i, k) for i < k and (j, l) for j != l, in the columns' order."""
    i, k = np.triu_indices(N, 1)
    j, l = np.nonzero(~np.eye(N, dtype=bool))
    return i, k, j, l


def matrix(cfg: dict, gen: torch.Generator) -> sp.csr_matrix:
    N = cfg["n"]
    m, n, _ = sizes(N)
    nx, Q = N * N, N * (N - 1)
    i, j, k, l = (a.ravel() for a in np.meshgrid(*[np.arange(N)] * 4,
                                                  indexing="ij"))
    keep = (i != k) & (j != l)
    i, j, k, l = i[keep], j[keep], k[keep], l[keep]
    # The y column of (i, j, k, l): read as (k, l, i, j) where i > k.
    lo = i < k
    a, b, c, d = (np.where(lo, p, q) for p, q in ((i, k), (j, l), (k, i),
                                                  (l, j)))
    pair = a * N - a * (a + 1) // 2 + (c - a - 1)
    ycol = nx + pair * Q + b * (N - 1) + d - (d > b)
    ij = i * N + j
    row_k = 2 * N + ij * (N - 1) + k - (k > i)  # sum over l of y_ijkl
    row_l = 2 * N + nx * (N - 1) + ij * (N - 1) + l - (l > j)  # over k
    # x_ij: +1 in its two assignment rows, -1 in the 2 (N - 1) rows above.
    x = np.arange(nx)
    link = (2 * N + np.arange(2 * nx * (N - 1))).reshape(2, nx, N - 1)
    rows = np.concatenate([row_k, row_l, x // N, N + x % N,
                           link[0].ravel(), link[1].ravel()])
    cols = np.concatenate([ycol, ycol, x, x,
                           np.repeat(x, N - 1), np.repeat(x, N - 1)])
    vals = np.concatenate([np.ones(2 * ycol.size + 2 * nx),
                           -np.ones(2 * nx * (N - 1))])
    return sp.csr_matrix((vals, (rows, cols)), shape=(m, n))


def member(cfg: dict, gen: torch.Generator) -> dict:
    N = cfg["n"]
    rows, cols = cfg["grid"]
    if rows * cols != N:
        raise ValueError(f"a grid of {rows} x {cols} has no {N} locations")
    m, n, _ = sizes(N)
    dev = gen.device
    draw = torch.randint(0, 11, (N, N), generator=gen, device=dev)
    F = torch.triu(draw, 1)
    F = (F + F.T).double()
    at = torch.arange(N, device=dev)
    r, s = at // cols, at % cols
    D = ((r[:, None] - r[None, :]).abs()
         + (s[:, None] - s[None, :]).abs()).double()
    i, k, j, l = (torch.as_tensor(v, device=dev) for v in _pairs(N))
    cy = (F[i, k][:, None] * D[j, l][None, :]
          + F[k, i][:, None] * D[l, j][None, :]).ravel()
    c = np.concatenate([np.zeros(N * N), cy.cpu().numpy()])
    rhs = np.concatenate([np.ones(2 * N), np.zeros(m - 2 * N)])
    return {"AL": rhs, "AU": rhs.copy(), "l": np.zeros(n),
            "u": np.full(n, np.inf), "c": c}
