"""CSR sparse matrix on a torch device, SpMV dispatch, and the row
reductions and scalings the scaling pipeline needs.

Counterpart of hprlp_tpu/ops/sparse.py.  The JAX package re-lays A out as
bucketed ELL and LaneELL tiles for the TPU; here the matrix is CSR (int32
indptr/indices), A and A^T are both stored, each over the other's padded
index space, and the solver attaches to each its column-strip tiles
(ops/tiles.py), on which the main-path SpMV runs.  The batched solver's
SpMM runs on the CSR arrays (ops/spmm.py), or on a dense copy of the
matrix that `with_backend(A, "dense")` attaches.  A single LP's SpMV
runs on the tiles, on the CSR arrays with their row-block plan (the
"gather" backend, ops/spmv.py::row_blocks) or on a dense copy, as
`with_spmv_backend` sets it up.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .spmm import csr_spmm, spmm_reference
from .spmv import (RowBlocks, csr_spmv, row_blocks, row_of_entry,
                   spmv_reference, tiled_spmv)
from .tiles import TiledMatrix, tiled_spmv_reference

INT32_MAX = 2**31 - 1
NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """A matrix on a device.  Its CSR arrays are None once `tiles_only`
    released them; the tiles then hold the matrix."""

    indptr: torch.Tensor | None   # (nrows + 1,) int32
    indices: torch.Tensor | None  # (nnz,) int32 column positions
    vals: torch.Tensor | None     # (nnz,) float32 or float64
    nrows: int
    ncols: int
    tiles: TiledMatrix | None = None  # the same matrix as SpMV tiles
    dense: torch.Tensor | None = None  # the same matrix, (nrows, ncols)
    blocks: RowBlocks | None = None  # the CSR kernel's row-block plan

    @property
    def nnz(self) -> int:
        if self.indices is None:
            return self.tiles.nnz
        return int(self.indices.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return (self.tiles if self.vals is None else self).vals.dtype

    @property
    def device(self) -> torch.device:
        return (self.tiles if self.vals is None else self).vals.device

    def with_vals(self, vals: torch.Tensor) -> "CsrMatrix":
        """New values; the tiles and the dense copy are dropped, since they
        hold the old ones.  The row-block plan holds none and stays."""
        return dataclasses.replace(self, vals=vals, tiles=None, dense=None)

    def with_tiles(self, tiles: TiledMatrix) -> "CsrMatrix":
        if (tiles.nrows, tiles.ncols, tiles.nnz) != (self.nrows, self.ncols,
                                                     self.nnz):
            raise ValueError("the tiles are of another matrix")
        return dataclasses.replace(self, tiles=tiles)

    def tiles_only(self) -> "CsrMatrix":
        """The matrix on its tiles alone: the CSR arrays, the row-block
        plan, a dense copy and the tiles' CSR order (`perm`) released, so
        the device keeps only what the tiled SpMV reads.  Nothing that
        reads the CSR arrays (the scaling, the "gather" backend, the
        batched SpMM, retile) runs on the result."""
        if self.tiles is None:
            raise ValueError("tiles_only needs the matrix's tiles")
        return dataclasses.replace(self, indptr=None, indices=None,
                                   vals=None, dense=None, blocks=None,
                                   tiles=self.tiles.without_perm())


def csr_from_numpy(indptr, indices, vals, nrows: int, ncols: int,
                   dtype: torch.dtype, device) -> CsrMatrix:
    """Upload host CSR arrays: int32 indices, and values cast to `dtype` on
    the host, so no wider copy crosses the link.  Raises if an index would
    not fit int32."""
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
        vals=torch.as_tensor(np.asarray(vals, np.float64).astype(
            NUMPY_DTYPES[dtype], copy=False), device=device),
        nrows=int(nrows), ncols=int(ncols))


def spmv(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  A dense copy, where attached, goes to the dense product.
    Else a CUDA tensor goes to a hand-written kernel (which raises on
    failure): the tiled kernel when A carries tiles, else the CSR kernel
    (on A's row-block plan, which it must carry).
    A CPU tensor goes to the matching plain version."""
    if A.dense is not None:
        return _dense_matmul(A.dense, x)
    if x.device.type == "cuda":
        return csr_spmv(A, x) if A.tiles is None else tiled_spmv(A.tiles, x)
    if x.device.type == "cpu":
        return (spmv_reference(A, x) if A.tiles is None
                else tiled_spmv_reference(A.tiles, x))
    raise ValueError(f"unsupported device {x.device}")


def densify(A: CsrMatrix) -> torch.Tensor:
    """A as a dense (nrows, ncols) tensor on A's device."""
    out = torch.zeros((A.nrows, A.ncols), dtype=A.dtype, device=A.device)
    return out.index_put_((row_of_entry(A), A.indices.to(torch.int64)),
                          A.vals, accumulate=True)


def with_backend(A: CsrMatrix, backend: str) -> CsrMatrix:
    """A configured for the batched SpMM: "dense" attaches a dense copy
    (built on A's device), "gather" drops it, so spmm runs the CSR kernel."""
    if backend == "dense":
        return A if A.dense is not None else dataclasses.replace(
            A, dense=densify(A))
    if backend == "gather":
        return dataclasses.replace(A, dense=None)
    raise ValueError(f"unknown SpMM backend {backend!r}")


def spmv_backend(A: CsrMatrix) -> str:
    """The SpMV backend `spmv` runs A on: "tiled" (the tiled kernel),
    "gather" (the CSR kernel) or "dense" (a dense product); the JAX
    package's "lane", "gather" and "dense"."""
    if A.dense is not None:
        return "dense"
    return "gather" if A.tiles is None else "tiled"


def with_spmv_backend(A: CsrMatrix, backend: str) -> CsrMatrix:
    """A configured for a single LP's SpMV: "tiled" keeps A's tiles (which
    it must carry) and drops a dense copy, "gather" drops both, "dense"
    attaches a dense copy (built on A's device) and drops the tiles.
    "gather" also attaches the CSR kernel's row-block plan where A has
    none.  Unlike with_backend, for the batched SpMM, "gather" here leaves
    no tiles."""
    if backend == "tiled":
        if A.tiles is None:
            raise ValueError("the tiled backend needs A's tiles")
        return dataclasses.replace(A, dense=None)
    if backend == "gather":
        return dataclasses.replace(
            A, tiles=None, dense=None,
            blocks=A.blocks if A.blocks is not None else row_blocks(A))
    if backend == "dense":
        return dataclasses.replace(with_backend(A, "dense"), tiles=None)
    raise ValueError(f"unknown SpMV backend {backend!r}")


def _dense_matmul(D: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """D @ X in full precision: a user's global TF32 setting must not
    change the iterates (the JAX package asks for Precision.HIGHEST)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(D, X)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def spmm(A: CsrMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for batched solves, X: (ncols, B) -> Y: (nrows, B).  A
    dense copy, where attached, goes to torch.matmul.  Else a CUDA tensor
    goes to the hand-written kernel (which raises on failure) and a CPU
    tensor to its plain version."""
    if A.dense is not None:
        return _dense_matmul(A.dense, X)
    if X.device.type == "cuda":
        return csr_spmm(A, X)
    if X.device.type == "cpu":
        return spmm_reference(A, X)
    raise ValueError(f"unsupported device {X.device}")


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _row_reduce(A: CsrMatrix, per_entry: torch.Tensor, reduce: str
                ) -> torch.Tensor:
    """Per-row "sum" or "amax" of a per-entry value.  On the card a sum
    runs on the SpMM kernel against a column of ones, which adds each row
    in CSR order, so it is bitwise repeatable; scatter_reduce_ sums by
    atomics there, in an order that changes from run to run.  A max does
    not depend on the order, and the CPU keeps scatter_reduce_."""
    if reduce == "sum" and _on_card(per_entry):
        ones = torch.ones((A.ncols, 1), dtype=per_entry.dtype,
                          device=per_entry.device)
        return csr_spmm(A.with_vals(per_entry), ones).view(A.nrows)
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
