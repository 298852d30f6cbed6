"""Set-covering LP at the published shape of rail4284.

Every column covers 10 or 11 distinct rows drawn uniformly (the 11s on
columns drawn uniformly, so that the total is the configuration's nnz
exactly), every entry is 1, costs are integers in {1, 2, 3}:

    minimize c'x  s.t.  A x >= 1,  x >= 0.

Drawn on the generator's device (the card in a run) in a few large calls,
and handed over as host arrays, as a caller holds them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def matrix(cfg: dict, gen: torch.Generator) -> sp.csr_matrix:
    m, n, nnz = cfg["rows"], cfg["cols"], cfg["nnz"]
    dev = gen.device
    base, extra = divmod(nnz, n)
    width = base + (extra > 0)
    counts = torch.full((n,), base, dtype=torch.int64, device=dev)
    counts[torch.randperm(n, generator=gen, device=dev)[:extra]] += 1
    rows = torch.randint(0, m, (n, width), generator=gen, device=dev)
    while True:  # redraw the columns that drew a row twice
        s = rows.sort(dim=1).values
        bad = (s[:, 1:] == s[:, :-1]).any(dim=1).nonzero().squeeze(1)
        if bad.numel() == 0:
            break
        rows[bad] = torch.randint(0, m, (bad.numel(), width), generator=gen,
                                  device=dev)
    # The first counts[j] draws of column j are distinct and uniform.
    keep = torch.arange(width, device=dev)[None, :] < counts[:, None]
    cols = torch.arange(n, device=dev)[:, None].expand(n, width)[keep]
    rows = rows[keep]
    order = torch.argsort(rows * n + cols)
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    return sp.csr_matrix(
        (np.ones(nnz), cols[order].to(torch.int32).cpu().numpy(),
         indptr.cpu().numpy()), shape=(m, n))


def member(cfg: dict, gen: torch.Generator) -> dict:
    m, n = cfg["rows"], cfg["cols"]
    c = torch.randint(1, 4, (n,), generator=gen, device=gen.device)
    return {"AL": np.ones(m), "AU": np.full(m, np.inf), "l": np.zeros(n),
            "u": np.full(n, np.inf), "c": c.double().cpu().numpy()}
