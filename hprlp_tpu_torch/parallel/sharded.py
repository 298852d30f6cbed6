"""Column and row sharding of a single LP's matrices over the ranks of a
mesh.

Counterpart of hprlp_tpu/parallel/sharded.py and of the lane route of
hprlp_tpu/ops/sparse.py (`_group_windows`, `_build_sharded_lane`): the
JAX package splits its lane tiles' chunk axis, grouped by x window, over
the devices; each runs the Pallas kernel on its groups against the
replicated x, and one psum completes the SpMV.  Here each rank holds the
tiles (ops/tiles.py) of a contiguous column slice of A, and of A^T, runs
the tiled kernel on its slice of x, which gives a partial y over all rows,
and one all-reduce sums the partials (ops/sparse.py::spmv on a `Shard`);
a middle iteration's half-update then runs as one epilogue kernel on the
summed vector (solver/chunk.py::x_half, y_half).
Vectors are replicated, so dots and norms need no collective.  Per
iteration that moves (m + n) values through all-reduces.

A rank's share of the matrix is what its tiles hold: A[:, C] and
A^T[:, R], where C are the columns of its slice of A and R those of its
slice of A^T (A's rows).  The share ingest (solver/loop.py::build_ingest
under a mesh) builds, uploads and scales only the share, as the JAX
package's sharded ingest places only each device's shards
(hprlp_tpu/parallel/sharded.py:67-84, ops/device_problem.py:422-569):
`share_cuts` and `host_share` cut it from A's CSR with no whole
transpose; the scaling reduces each row of A over A[R, :] and each row
of A^T over A^T[C, :], whole on exactly one rank, and
`ScalingShare.gather` puts the ranks' row results together
(solver/scaling.py); `shard_from_share` lays the tiles out with the
factors replayed in each form's order, so they are bitwise
`shard_matrix`'s tiles of the one-card ingest, which stays as the
tests' reference.

Row sharding is the counterpart of the JAX package's row-sharded ELL
buckets (its "gather" and "dense" backends under a mesh,
hprlp_tpu/parallel/sharded.py:44-84, where XLA inserts the all-gathers):
a rank holds the scaled row forms themselves, A[R, :] and A^T[C, :], each
with a `RowShard` and the row-block plan of the CSR kernel or a dense
copy (`rows_from_share`).  y[R] = A[R, :] x and (A^T y)[C] = A^T[C, :] y
run on the whole replicated operand, and one all-gather per SpMV (per
fused half) puts the ranks' rows together (ops/sparse.py::spmv,
solver/chunk.py::x_half/y_half): (m + n) values per iteration, as the
columns' all-reduces move.  The row forms are the ones the scaling
scaled in place, so they are bitwise the one-card ingest's A[R, :] and
A^T[C, :], and with them no column form is uploaded and no tile built.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ..ops.device_problem import LpDevice, padded_csr
from ..ops.sparse import (CsrMatrix, RowShard, Shard, scale_cols, scale_rows,
                          with_spmv_backend)
from ..ops.spmv import row_of_entry
from ..ops.tiles import build_tiles

# Slices are cut at multiples of this many columns: x[c0:c1] then starts
# 16-byte aligned for the tiled kernel's bulk copies of its strips
# (ops/spmv.py::check_tiled_layout), and a cut never splits a 32-column
# block.
SLICE_ALIGN = 32


def column_slices(col_nnz, world: int) -> list[tuple[int, int]]:
    """`world` contiguous column ranges [c0, c1) that cover [0, ncols),
    ncols = len(col_nnz), each cut a multiple of SLICE_ALIGN or ncols, and
    balanced by nnz: cut k is the block boundary nearest to k * nnz /
    world, so each slice's nnz is within one block's of nnz / world.  A
    slice may be empty."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    col_nnz = np.asarray(col_nnz, np.int64)
    ncols = col_nnz.shape[0]
    nb = -(-ncols // SLICE_ALIGN)
    blocks = np.zeros(nb * SLICE_ALIGN, np.int64)
    blocks[:ncols] = col_nnz
    cum = np.concatenate([[0], np.cumsum(
        blocks.reshape(nb, SLICE_ALIGN).sum(axis=1))])
    total = int(cum[-1])
    cuts = [0]
    for k in range(1, world):
        target = k * total / world
        b = int(np.searchsorted(cum, target))  # cum[b - 1] < target
        if b > 0 and target - cum[b - 1] <= cum[min(b, nb)] - target:
            b -= 1
        cuts.append(max(cuts[-1], min(b, nb)))
    bounds = [min(c * SLICE_ALIGN, ncols) for c in cuts] + [ncols]
    return list(zip(bounds[:-1], bounds[1:]))


def slice_columns(M: CsrMatrix, c0: int, c1: int) -> CsrMatrix:
    """M[:, c0:c1] as a CSR matrix of c1 - c0 columns on M's device (torch
    ops; each row keeps its entries' order)."""
    if not 0 <= c0 <= c1 <= M.ncols:
        raise ValueError(f"columns [{c0}, {c1}) outside [0, {M.ncols})")
    keep = (M.indices >= c0) & (M.indices < c1)
    counts = torch.bincount(row_of_entry(M)[keep], minlength=M.nrows)
    indptr = torch.zeros(M.nrows + 1, dtype=torch.int64,
                         device=M.indptr.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return CsrMatrix(indptr=indptr.to(torch.int32),
                     indices=M.indices[keep] - c0, vals=M.vals[keep],
                     nrows=M.nrows, ncols=c1 - c0)


def shard_matrix(M: CsrMatrix, rank: int, world: int, group=None
                 ) -> CsrMatrix:
    """M as rank `rank` of `world` holds it: the tiles of its column slice
    (column_slices of M's column counts) without their CSR order, and a
    Shard; no CSR arrays.  nrows and ncols stay M's."""
    col_nnz = torch.bincount(M.indices.to(torch.int64), minlength=M.ncols)
    c0, c1 = column_slices(col_nnz.cpu().numpy(), world)[rank]
    tiles = build_tiles(slice_columns(M, c0, c1)).without_perm()
    return CsrMatrix(indptr=None, indices=None, vals=None, nrows=M.nrows,
                     ncols=M.ncols, tiles=tiles,
                     shard=Shard(c0=c0, c1=c1, group=group))


def shard_problem(lp: LpDevice, rank: int, world: int, group=None
                  ) -> LpDevice:
    """lp with A sliced by A's columns and A^T by A^T's columns (A's rows),
    each slice kept as its tiles alone (shard_matrix), A's whole CSR arrays
    dropped before A^T's slice is tiled; the vectors stay replicated."""
    lp = dataclasses.replace(lp, A=shard_matrix(lp.A, rank, world, group))
    return dataclasses.replace(lp, AT=shard_matrix(lp.AT, rank, world,
                                                   group))


def share_cuts(A: sp.csr_matrix, m_pad: int, n_pad: int, rank: int,
               world: int) -> tuple[tuple, tuple, int]:
    """(row cuts, column cuts, entries) of rank `rank` of `world` for
    canonical CSR A padded to (m_pad, n_pad).  Every rank's rows of A, cut
    by column_slices over A's row counts (A^T's column counts), and
    columns of A, cut over A's column counts -- the ranges shard_matrix
    cuts from the padded A^T and A -- as world + 1 bounds each: rank r's
    R is [row_cuts[r], row_cuts[r + 1]) and its C likewise.  entries:
    rank `rank`'s share's, those of A[R, :] and of A[:, C]."""
    m = A.shape[0]
    row_nnz = np.zeros(m_pad, np.int64)
    row_nnz[:m] = np.diff(A.indptr)
    col_nnz = np.bincount(A.indices, minlength=n_pad)
    rows, cols = (column_slices(row_nnz, world),
                  column_slices(col_nnz, world))
    (r0, r1), (c0, c1) = rows[rank], cols[rank]
    entries = int(row_nnz[r0:r1].sum() + col_nnz[c0:c1].sum())
    return (tuple(a for a, _ in rows) + (m_pad,),
            tuple(a for a, _ in cols) + (n_pad,), entries)


@dataclasses.dataclass
class HostShare:
    """Rank's share of A on the host, canonical CSR (sorted columns), each
    entry in two forms.  The row forms, which the scaling reduces:
    a_rows = A[R, :] and at_rows = A^T[C, :].  The column forms, which the
    tiles hold: a_cols = A[:, C] and at_cols = A^T[:, R].  Each is cut to
    A's real rows and columns: the padding adds empty rows and columns
    only (padded_csr).  A share for the row shards alone has no column
    forms (None)."""

    rows: tuple[int, int]
    cols: tuple[int, int]
    m_pad: int
    n_pad: int
    a_rows: sp.csr_matrix | None
    at_rows: sp.csr_matrix | None
    a_cols: sp.csr_matrix | None
    at_cols: sp.csr_matrix | None


def host_share(A: sp.csr_matrix, m_pad: int, n_pad: int,
               rows: tuple[int, int], cols: tuple[int, int],
               col_forms: bool = True) -> HostShare:
    """The share of rows R = `rows` and columns C = `cols` (share_cuts) of
    canonical CSR A (m x n) padded to (m_pad, n_pad): a row slice and a
    column slice of A, each transposed once, so no rank transposes the
    whole matrix.  Without `col_forms` the column forms are left out, and
    A[R, :] is not transposed."""
    m, n = A.shape
    (r0, r1), (c0, c1) = rows, cols
    a_rows = A[min(r0, m):min(r1, m), :]
    a_cols = A[:, min(c0, n):min(c1, n)].tocsr()
    return HostShare(rows=rows, cols=cols, m_pad=m_pad, n_pad=n_pad,
                     a_rows=a_rows, at_rows=a_cols.T.tocsr(),
                     a_cols=a_cols if col_forms else None,
                     at_cols=a_rows.T.tocsr() if col_forms else None)


def upload_rows(share: HostShare, dtype, device) -> tuple[CsrMatrix,
                                                          CsrMatrix]:
    """The row forms on `device`: A[R, :] as (|R|, n_pad) and A^T[C, :] as
    (|C|, m_pad), each at `dtype`."""
    (r0, r1), (c0, c1) = share.rows, share.cols
    return (padded_csr(share.a_rows, r1 - r0, share.n_pad, dtype, device),
            padded_csr(share.at_rows, c1 - c0, share.m_pad, dtype, device))


@dataclasses.dataclass
class ScalingShare:
    """What solver/scaling.py::scale_matrix needs to scale a rank's row
    forms as the one-card scaling scales the whole: A's rows start at
    a0 and A^T's at at0 (A's column), of m and n (padded); `gather`
    exchanges per-row results; `passes` records each pass's (row, column)
    factors, as applied to A, for shard_from_share."""

    a0: int
    at0: int
    m: int
    n: int
    group: object = None
    exchanges: int = 0
    passes: list = dataclasses.field(default_factory=list)

    def gather(self, a=None, at=None):
        """(the whole per-row vector of A, of A^T) from each rank's
        results for its own rows, `a` (of A's rows from a0) and `at` (of
        A^T's from at0), either None for none: one all-reduce SUM of
        zeros in which each rank wrote its own range, so every value is
        one rank's, moved with no arithmetic (sums start from +0.0, so
        none is -0.0)."""
        part = a if a is not None else at
        sizes = [self.m if a is not None else 0,
                 self.n if at is not None else 0]
        buf = torch.zeros(sum(sizes), dtype=part.dtype, device=part.device)
        if a is not None:
            buf[self.a0:self.a0 + a.numel()] = a
        if at is not None:
            buf[sizes[0] + self.at0:sizes[0] + self.at0 + at.numel()] = at
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        self.exchanges += 1
        whole_a, whole_at = buf.split(sizes)
        return (whole_a if a is not None else None,
                whole_at if at is not None else None)


def replay_passes(M: CsrMatrix, passes, transposed: bool, c0: int
                  ) -> CsrMatrix:
    """M, a column slice [c0, c0 + M.ncols) of A (or of A^T, transposed),
    scaled by `passes` as scale_matrix scaled A (A^T): each entry
    times its row's factor, then its column's, A's (row, column) factors
    swapped for A^T.  Elementwise, so bitwise the one-card values."""
    for r, c in passes:
        rows, cols = (c, r) if transposed else (r, c)
        M = scale_cols(scale_rows(M, rows), cols[c0:c0 + M.ncols])
    return M


def shard_from_share(share: HostShare, passes, dtype, device, group=None
                     ) -> tuple[CsrMatrix, CsrMatrix]:
    """(A, A^T) as this rank holds them under a mesh, from its share's
    column forms: each uploaded, scaled by `passes` (replay_passes) and
    laid out as its tiles alone with a Shard, A's before A^T's.  Bitwise
    shard_matrix's from the one-card ingest."""
    out = []
    for name, (k0, k1), nrows, transposed in (
            ("a_cols", share.cols, share.m_pad, False),
            ("at_cols", share.rows, share.n_pad, True)):
        M = padded_csr(getattr(share, name), nrows, k1 - k0, dtype, device)
        setattr(share, name, None)
        M = replay_passes(M, passes, transposed, k0)
        tiles = build_tiles(M).without_perm()
        del M
        out.append(CsrMatrix(indptr=None, indices=None, vals=None,
                             nrows=nrows, ncols=share.n_pad if not transposed
                             else share.m_pad, tiles=tiles,
                             shard=Shard(c0=k0, c1=k1, group=group)))
    return out[0], out[1]


def rows_from_share(A_rows: CsrMatrix, AT_rows: CsrMatrix, row_cuts,
                    col_cuts, rank: int, backend: str, group=None
                    ) -> tuple[CsrMatrix, CsrMatrix]:
    """(A, A^T) row-sharded as rank `rank` holds them, from its scaled row
    forms A[R, :] ((|R|, n_pad), R = row_cuts[rank:rank + 2]) and A^T[C, :]
    ((|C|, m_pad), C from col_cuts; share_cuts' bounds): each with a
    RowShard, its nrows the whole matrix's, laid out for `backend` by
    with_spmv_backend on its rows: "gather" the CSR kernel's row-block
    plan, "dense" a dense copy of its rows."""
    out = []
    for M, cuts in ((A_rows, row_cuts), (AT_rows, col_cuts)):
        M = dataclasses.replace(M, nrows=cuts[-1],
                                row_shard=RowShard(cuts=tuple(cuts),
                                                   rank=rank, group=group))
        out.append(with_spmv_backend(M, backend))
    return out[0], out[1]
