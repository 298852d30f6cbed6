"""Column sharding of a single LP's matrices over the ranks of a mesh.

Counterpart of hprlp_tpu/parallel/sharded.py and of the lane route of
hprlp_tpu/ops/sparse.py (`_group_windows`, `_build_sharded_lane`): the
JAX package splits its lane tiles' chunk axis, grouped by x window, over
the devices; each runs the Pallas kernel on its groups against the
replicated x, and one psum completes the SpMV.  Here each rank holds the
tiles (ops/tiles.py) of a contiguous column slice of A, and of A^T, runs
the tiled kernel on its slice of x, which gives a partial y over all rows,
and one all-reduce sums the partials (ops/sparse.py::spmv on a `Shard`).
Vectors are replicated, so dots and norms need no collective.  Per
iteration that moves (m + n) values through all-reduces.

The JAX package's row-sharded buckets (its "gather" backend under a mesh)
have no counterpart yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.device_problem import LpDevice
from ..ops.sparse import CsrMatrix, Shard
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
