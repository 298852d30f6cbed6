"""Device-resident LP problem: padded CSR A and A^T plus padded vectors.

Counterpart of hprlp_tpu/ops/device_problem.py (build_device_problem,
LpDevice, HostMaps), with the same padding semantics: padding rows are free
constraints (AL=-inf, AU=+inf), so their dual iterate stays zero, and
padding columns are variables fixed at zero (l=u=0, c=0), so their primal
iterate and dual residual stay zero.  The padded problem is equivalent to
the original and the hot loop needs no masks.

The default layout keeps the original row and column order and pads each
space to a multiple of PAD_MULTIPLE.  The TPU package's layout passes
(window balancing, residue balancing, locality-major plans, cell routing)
serve its LaneELL crossbar only and have no counterpart here; a caller may
still pass positions and padded sizes (row_pos, col_pos, m_pad, n_pad) to
reproduce another layout index for index, as the parity tests do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..problem import LpProblem
from .sparse import CsrMatrix, csr_from_numpy
from .spmv import row_blocks
from .tiles import TiledMatrix

PAD_MULTIPLE = 32


@dataclasses.dataclass(frozen=True)
class LpDevice:
    """Padded LP data on a device (parity: LP_info_gpu,
    include/structs.h:243-252)."""

    A: CsrMatrix   # (m_pad, n_pad)
    AT: CsrMatrix  # (n_pad, m_pad)
    AL: torch.Tensor  # (m_pad,)
    AU: torch.Tensor
    c: torch.Tensor   # (n_pad,)
    l: torch.Tensor
    u: torch.Tensor

    @property
    def m(self) -> int:
        return self.A.nrows

    @property
    def n(self) -> int:
        return self.A.ncols


@dataclasses.dataclass(frozen=True)
class HostMaps:
    """Host-side bookkeeping between the original and padded spaces."""

    row_pos: np.ndarray  # (m_orig,) -> padded row index
    col_pos: np.ndarray  # (n_orig,) -> padded col index
    m_orig: int
    n_orig: int
    obj_constant: float
    objective_sense: int


def padded_size(size: int, multiple: int = PAD_MULTIPLE) -> int:
    return -(-max(size, 1) // multiple) * multiple


def _positions(pos, size: int, size_pad: int, what: str) -> np.ndarray:
    if pos is None:
        return np.arange(size, dtype=np.int64)
    pos = np.asarray(pos, np.int64)
    if pos.shape != (size,) or (size and (pos.min() < 0
                                          or pos.max() >= size_pad)):
        raise ValueError(f"{what} must map {size} entries into "
                         f"[0, {size_pad})")
    if len(np.unique(pos)) != size:
        raise ValueError(f"{what} has repeated positions")
    return pos


def csr_from_coo(rows, cols, vals, nrows: int, ncols: int,
                 dtype: torch.dtype, device) -> CsrMatrix:
    """CSR (sorted column indices, explicit zeros kept) from COO entries
    at distinct positions."""
    M = sp.coo_matrix((np.asarray(vals, np.float64),
                       (np.asarray(rows, np.int64), np.asarray(cols, np.int64))),
                      shape=(nrows, ncols)).tocsr()
    M.sort_indices()
    return csr_from_numpy(M.indptr, M.indices, M.data, nrows, ncols, dtype,
                          device)


def attach_tiles(lp: LpDevice, tiles_A: TiledMatrix, tiles_AT: TiledMatrix
                 ) -> LpDevice:
    """lp with the SpMV tiles of A and A^T attached, their values gathered
    from lp's (possibly rescaled) matrices; the tiles may have been built
    on the same structure before scaling."""
    return dataclasses.replace(
        lp, A=lp.A.with_tiles(tiles_A.retile(lp.A.vals)),
        AT=lp.AT.with_tiles(tiles_AT.retile(lp.AT.vals)))


def attach_blocks(lp: LpDevice) -> LpDevice:
    """lp with the CSR kernel's row-block plans of A and A^T attached
    (ops/spmv.py::row_blocks): the "gather" backend's layout."""
    return dataclasses.replace(
        lp, A=dataclasses.replace(lp.A, blocks=row_blocks(lp.A)),
        AT=dataclasses.replace(lp.AT, blocks=row_blocks(lp.AT)))


def build_device_problem(problem: LpProblem, dtype=torch.float32,
                         device="cpu", row_pos=None, col_pos=None,
                         m_pad: int | None = None, n_pad: int | None = None
                         ) -> tuple[LpDevice, HostMaps]:
    """Lay an LpProblem out on `device` as padded CSR A and A^T."""
    A = problem.A.tocsr()
    A.sum_duplicates()
    m, n = A.shape
    m_pad = padded_size(m) if m_pad is None else int(m_pad)
    n_pad = padded_size(n) if n_pad is None else int(n_pad)
    if m_pad < m or n_pad < n:
        raise ValueError(f"padded sizes ({m_pad}, {n_pad}) below ({m}, {n})")
    row_pos = _positions(row_pos, m, m_pad, "row_pos")
    col_pos = _positions(col_pos, n, n_pad, "col_pos")

    coo = A.tocoo()
    rows, cols = row_pos[coo.row], col_pos[coo.col]
    A_dev = csr_from_coo(rows, cols, coo.data, m_pad, n_pad, dtype, device)
    AT_dev = csr_from_coo(cols, rows, coo.data, n_pad, m_pad, dtype, device)

    def scatter_vec(vals, pos, size, fill):
        out = np.full(size, fill, dtype=np.float64)
        out[pos] = vals
        return torch.as_tensor(out, device=device).to(dtype)

    lp = LpDevice(A=A_dev, AT=AT_dev,
                  AL=scatter_vec(problem.AL, row_pos, m_pad, -np.inf),
                  AU=scatter_vec(problem.AU, row_pos, m_pad, np.inf),
                  c=scatter_vec(problem.c, col_pos, n_pad, 0.0),
                  l=scatter_vec(problem.l, col_pos, n_pad, 0.0),
                  u=scatter_vec(problem.u, col_pos, n_pad, 0.0))
    maps = HostMaps(row_pos=row_pos, col_pos=col_pos, m_orig=m, n_orig=n,
                    obj_constant=float(problem.obj_constant),
                    objective_sense=problem.objective_sense)
    return lp, maps
