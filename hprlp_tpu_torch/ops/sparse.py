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

Under a mesh (parallel/sharded.py) each rank holds a part of the whole
matrix, in one of two forms (or both, while the autotune decides):
  * a `Shard` (columns): its tiles hold the rank's column slice
    A[:, c0:c1], and `spmv` runs the tiled kernel on x[c0:c1], which gives
    a partial y over all rows, then sums the ranks' partials with one
    all-reduce (`all_reduce_sum`), the JAX package's psum;
  * a `RowShard` (rows): its CSR arrays, with their row-block plan or a
    dense copy, hold the rank's rows A[r0:r1, :], and `spmv` runs the CSR
    kernel (or the dense product) on the whole x, which gives y[r0:r1],
    then puts the ranks' rows together with one all-gather
    (`all_gather_rows`), as XLA's all-gathers complete the JAX package's
    row-sharded buckets.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist

from .spmm import csr_spmm, spmm_reference
from .spmv import (RowBlocks, csr_spmv, row_blocks, row_of_entry,
                   spmv_reference, tiled_spmv)
from .tiles import TiledMatrix, tiled_spmv_reference

INT32_MAX = 2**31 - 1
NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's part of a matrix column-sharded over a process group:
    columns [c0, c1), whose tiles the rank holds.  group: the
    torch.distributed group the partial products are summed over (None:
    the default group)."""

    c0: int
    c1: int
    group: object = None


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's part of a matrix row-sharded over a process group: rows
    [r0, r1) = [cuts[rank], cuts[rank + 1]), whose CSR arrays the rank
    holds.  cuts: every rank's first row, then the row count (world + 1
    ascending bounds), which place each rank's rows in the gathered y.
    group: as Shard's."""

    cuts: tuple
    rank: int
    group: object = None

    @property
    def r0(self) -> int:
        return self.cuts[self.rank]

    @property
    def r1(self) -> int:
        return self.cuts[self.rank + 1]

    @property
    def width(self) -> int:
        """The most rows any rank holds: each rank's slot in a gather."""
        return max(b - a for a, b in zip(self.cuts, self.cuts[1:]))


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """A matrix on a device.  Its CSR arrays are None once `tiles_only`
    released them, or on a column shard; the tiles then hold the matrix
    (on a shard, its columns [shard.c0, shard.c1) only).  On a row shard
    the CSR arrays, the plan and a dense copy hold its rows [row_shard.r0,
    row_shard.r1) only (`rows_local`).  Sharded, nrows and ncols stay the
    whole matrix's."""

    indptr: torch.Tensor | None   # (nrows + 1,) int32
    indices: torch.Tensor | None  # (nnz,) int32 column positions
    vals: torch.Tensor | None     # (nnz,) float32 or float64
    nrows: int
    ncols: int
    tiles: TiledMatrix | None = None  # the same matrix as SpMV tiles
    dense: torch.Tensor | None = None  # the same matrix, (nrows, ncols)
    blocks: RowBlocks | None = None  # the CSR kernel's row-block plan
    shard: Shard | None = None  # this rank's columns under a mesh
    row_shard: RowShard | None = None  # this rank's rows under a mesh

    @property
    def nnz(self) -> int:
        """Stored entries; sharded, those of this rank's rows (where it
        holds its CSR arrays) or else of its columns."""
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

    @property
    def sharding(self) -> Shard | RowShard | None:
        """The shard this rank's matrix is under a mesh, else None."""
        return self.shard or self.row_shard

    def tiles_only(self) -> "CsrMatrix":
        """The matrix on its tiles alone: the CSR arrays, the row-block
        plan, a dense copy, a row shard and the tiles' CSR order (`perm`)
        released, so the device keeps only what the tiled SpMV reads.
        Nothing that reads the CSR arrays (the scaling, the "gather"
        backend, the batched SpMM, retile) runs on the result."""
        if self.tiles is None:
            raise ValueError("tiles_only needs the matrix's tiles")
        return dataclasses.replace(self, indptr=None, indices=None,
                                   vals=None, dense=None, blocks=None,
                                   row_shard=None,
                                   tiles=self.tiles.without_perm())

    def rows_local(self) -> "CsrMatrix":
        """On a row shard, this rank's rows as a matrix of their own
        (r1 - r0 rows, no shard): what the kernels and plain versions
        take."""
        rs = self.row_shard
        if rs is None:
            raise ValueError("rows_local needs a row shard")
        return dataclasses.replace(self, nrows=rs.r1 - rs.r0, tiles=None,
                                   shard=None, row_shard=None)


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


def all_reduce_sum(y: torch.Tensor, group=None) -> torch.Tensor:
    """y summed in place over the ranks of `group` (torch.distributed's
    all_reduce: NCCL on the card, gloo on the CPU); every rank gets the
    same bits.  Counts its calls in `all_reduce_sum.launches`, as the
    kernel wrappers count theirs.  Raises on a failed or timed-out
    collective."""
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum.launches += 1
    return y


all_reduce_sum.launches = 0


def all_gather_rows(parts, shard: RowShard) -> list[torch.Tensor]:
    """The whole vectors whose rows [r0, r1) of `shard` are this rank's
    `parts` (each of r1 - r0 values, one dtype and device), by one
    all-gather over the ranks of shard.group (NCCL on the card, gloo on
    the CPU): the parts are packed into this rank's slot of shard.width
    values each, and every rank's rows are copied out of the gathered
    slots, so every rank gets the same bits, a -0.0 kept.  (An all-reduce
    of zeros, as ScalingShare.gather moves rows, would move twice the
    bytes and turn a -0.0 iterate into +0.0.)  dist.all_gather_into_tensor
    is the call both the card's torch and later ones have; later ones warn
    that it is deprecated, which is kept quiet here.  Counts its calls in
    `all_gather_rows.launches`.  Raises on a failed or timed-out
    collective."""
    cuts, width = shard.cuts, shard.width
    world = len(cuts) - 1
    p0 = parts[0]
    send = torch.empty((len(parts), width), dtype=p0.dtype, device=p0.device)
    for i, p in enumerate(parts):
        send[i, :p.numel()] = p
    recv = torch.empty((world, len(parts), width), dtype=p0.dtype,
                       device=p0.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(recv.view(-1), send.view(-1),
                                    group=shard.group)
    all_gather_rows.launches += 1
    return [torch.cat([recv[r, i, :cuts[r + 1] - cuts[r]]
                       for r in range(world)]) for i in range(len(parts))]


all_gather_rows.launches = 0


def spmv(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  A dense copy, where attached, goes to the dense product.
    Else a CUDA tensor goes to a hand-written kernel (which raises on
    failure): the tiled kernel when A carries tiles, else the CSR kernel
    (on A's row-block plan, which it must carry).
    A CPU tensor goes to the matching plain version.  On a column shard
    (with its tiles), the tiled kernel (or its plain version) on x[c0:c1]
    gives this rank's partial y, and all_reduce_sum adds the ranks'
    partials; on a row shard, spmv of this rank's rows (rows_local) gives
    y[r0:r1], and all_gather_rows puts the ranks' rows together."""
    if A.shard is not None and A.tiles is not None:
        xs = x[A.shard.c0:A.shard.c1]
        part = (tiled_spmv(A.tiles, xs) if x.device.type == "cuda"
                else tiled_spmv_reference(A.tiles, xs))
        return all_reduce_sum(part, A.shard.group)
    if A.row_shard is not None:
        return all_gather_rows([spmv(A.rows_local(), x)], A.row_shard)[0]
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
    it must carry: on a mesh, a column shard's) and drops a dense copy,
    "gather" drops both, "dense" attaches a dense copy (built on A's
    device) and drops the tiles.  "gather" also attaches the CSR kernel's
    row-block plan where A has none.  Unlike with_backend, for the batched
    SpMM, "gather" here leaves no tiles.  On a row shard the plan and the
    dense copy are of this rank's rows (rows_local), and "gather" and
    "dense" drop the column shard with the tiles."""
    if backend == "tiled":
        if A.tiles is None:
            raise ValueError("the tiled backend needs A's tiles (on a mesh, "
                             "a column shard's: a row shard has none)")
        return dataclasses.replace(A, dense=None)
    rows = A.rows_local() if A.row_shard is not None else A
    if backend == "gather":
        return dataclasses.replace(
            A, tiles=None, shard=None, dense=None,
            blocks=A.blocks if A.blocks is not None else row_blocks(rows))
    if backend == "dense":
        return dataclasses.replace(
            A, tiles=None, shard=None,
            dense=A.dense if A.dense is not None else densify(rows))
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
