"""CSR sparse matrix on a torch device, SpMV dispatch, and the row
reductions and scalings the scaling pipeline needs.

Counterpart of hprlp_tpu/ops/sparse.py.  The JAX package re-lays A out as
bucketed ELL and LaneELL tiles for the TPU; here the matrix is CSR (int32
indptr/indices), A and A^T are both stored, each over the other's padded
index space, and the solver attaches to each its column-strip tiles
(ops/tiles.py), on which the main-path SpMV runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .spmv import csr_spmv, row_of_entry, spmv_reference, tiled_spmv
from .tiles import TiledMatrix, tiled_spmv_reference

INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    indptr: torch.Tensor   # (nrows + 1,) int32
    indices: torch.Tensor  # (nnz,) int32 column positions
    vals: torch.Tensor     # (nnz,) float32 or float64
    nrows: int
    ncols: int
    tiles: TiledMatrix | None = None  # the same matrix as SpMV tiles

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def with_vals(self, vals: torch.Tensor) -> "CsrMatrix":
        """New values; the tiles are dropped, since they hold the old ones."""
        return dataclasses.replace(self, vals=vals, tiles=None)

    def with_tiles(self, tiles: TiledMatrix) -> "CsrMatrix":
        if (tiles.nrows, tiles.ncols, tiles.nnz) != (self.nrows, self.ncols,
                                                     self.nnz):
            raise ValueError("the tiles are of another matrix")
        return dataclasses.replace(self, tiles=tiles)


def csr_from_numpy(indptr, indices, vals, nrows: int, ncols: int,
                   dtype: torch.dtype, device) -> CsrMatrix:
    """Upload host CSR arrays.  Raises if an index would not fit int32."""
    indptr = np.asarray(indptr)
    nnz = int(indptr[-1]) if len(indptr) else 0
    if nnz > INT32_MAX or nrows > INT32_MAX or ncols > INT32_MAX:
        raise ValueError(f"CSR with nnz={nnz}, shape=({nrows}, {ncols}) "
                         f"exceeds int32 indexing")
    if len(indptr) != nrows + 1:
        raise ValueError(f"indptr has {len(indptr)} entries, expected "
                         f"{nrows + 1}")
    return CsrMatrix(
        indptr=torch.as_tensor(indptr.astype(np.int32), device=device),
        indices=torch.as_tensor(np.asarray(indices, np.int32), device=device),
        vals=torch.as_tensor(np.asarray(vals, np.float64), device=device
                             ).to(dtype),
        nrows=int(nrows), ncols=int(ncols))


def spmv(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  A CUDA tensor goes to a hand-written kernel (which
    raises on failure): the tiled kernel when A carries tiles, else the CSR
    kernel.  A CPU tensor goes to the matching plain version."""
    if x.device.type == "cuda":
        return csr_spmv(A, x) if A.tiles is None else tiled_spmv(A.tiles, x)
    if x.device.type == "cpu":
        return (spmv_reference(A, x) if A.tiles is None
                else tiled_spmv_reference(A.tiles, x))
    raise ValueError(f"unsupported device {x.device}")


def _row_reduce(A: CsrMatrix, per_entry: torch.Tensor, reduce: str
                ) -> torch.Tensor:
    out = torch.zeros(A.nrows, dtype=per_entry.dtype, device=per_entry.device)
    return out.scatter_reduce_(0, row_of_entry(A), per_entry, reduce=reduce,
                               include_self=True)


def row_inf_norms(A: CsrMatrix) -> torch.Tensor:
    """Per-row max |a_ij| (0 for empty rows)."""
    return _row_reduce(A, A.vals.abs(), "amax")


def row_one_norms(A: CsrMatrix) -> torch.Tensor:
    """Per-row sum |a_ij|."""
    return _row_reduce(A, A.vals.abs(), "sum")


def row_masked_mean(A: CsrMatrix, per_entry: torch.Tensor) -> torch.Tensor:
    """Per-row mean of a per-entry value over the stored entries; 0 for
    empty rows (reference: src/scaling.cu:5-31 Curtis-Reid row update)."""
    cnt = (A.indptr[1:] - A.indptr[:-1]).to(per_entry.dtype)
    s = _row_reduce(A, per_entry, "sum")
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1), 0.0)


def scale_rows(A: CsrMatrix, s: torch.Tensor) -> CsrMatrix:
    """A with row i multiplied by s[i]."""
    return A.with_vals(A.vals * s[row_of_entry(A)])


def scale_cols(A: CsrMatrix, s: torch.Tensor) -> CsrMatrix:
    """A with column j multiplied by s[j]."""
    return A.with_vals(A.vals * s[A.indices.to(torch.int64)])
