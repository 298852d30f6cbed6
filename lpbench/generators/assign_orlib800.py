"""LP relaxation of an n x n linear assignment problem, OR-Library style.

x[i, j] is column i * n + j; rows 0 .. n - 1 sum the rows of x, rows
n .. 2n - 1 its columns, each to 1; 0 <= x <= 1; costs are integers drawn
uniformly from 1 to 100:

    minimize c'x  s.t.  A x = 1,  0 <= x <= 1.

The costs are drawn on the generator's device (the card in a run) and
handed over as host arrays, as a caller holds them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def matrix(cfg: dict, gen: torch.Generator) -> sp.csr_matrix:
    n = cfg["n"]
    cols = np.arange(n * n, dtype=np.int32)
    # Row i holds columns i * n .. i * n + n - 1; row n + j holds j, n + j,
    # ..., each row's columns ascending.
    indices = np.concatenate([cols, cols.reshape(n, n).T.ravel()])
    indptr = np.arange(2 * n + 1, dtype=np.int64) * n
    return sp.csr_matrix((np.ones(2 * n * n), indices, indptr),
                         shape=(2 * n, n * n))


def member(cfg: dict, gen: torch.Generator) -> dict:
    n = cfg["n"]
    c = torch.randint(1, 101, (n * n,), generator=gen, device=gen.device)
    return {"AL": np.ones(2 * n), "AU": np.ones(2 * n),
            "l": np.zeros(n * n), "u": np.ones(n * n),
            "c": c.double().cpu().numpy()}
