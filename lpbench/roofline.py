"""The least time of an HPR-LP iteration's two halves on one H100: a frozen
copy of the port's byte model (hprlp_tpu_torch/prof/timing.py, half_bytes
and half_bound), so that the yardstick stays put while the program moves.

A middle iteration is two fused half-updates.  The x-half runs over A^T
(n rows): it streams A^T's entries and row pointers once, gathers y (m
values a member) and reads or writes 7 (n, B) row tensors (x, last_x, c,
l, u in; x, x_hat out).  The y-half runs over A (m rows): its entries,
x_hat (n values a member) and 5 (m, B) row tensors (y, last_y, AL, AU in;
y out).  Each adds the (B,) scalar, counter and mask of every member.
These are the function's least bytes, whatever kernel computes it.  Its
operations are 2 nnz B multiply-adds and ~12 a (row, member) of the
update.  The least time is the larger of bytes over the HBM rate and
operations over the vector-unit peak: NVIDIA's data sheet for the H100 SXM
at its 700 W power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"f32": 67e12, "f64": 34e12}
ITEMSIZE = {"f32": 4, "f64": 8}
HALF_ROW_TENSORS = {"x": 7, "y": 5}


def half_bytes(nrows: int, ncols: int, nnz: int, dtype: str, batch: int,
               half: str) -> int:
    """Bytes one fused half moves over a matrix of nrows x ncols and nnz
    entries (A^T for the x-half, A for the y-half): values and int32
    column indices, int32 row pointers, the gathered operand, the row
    tensors, and per member a scalar, an int32 counter and a bool mask."""
    v = ITEMSIZE[dtype]
    return (nnz * (v + 4) + (nrows + 1) * 4 + batch * ncols * v
            + HALF_ROW_TENSORS[half] * batch * nrows * v
            + batch * (v + 4 + 1))


def half_seconds(nrows: int, ncols: int, nnz: int, dtype: str, batch: int,
                 half: str) -> float:
    """The least time of one fused half."""
    ops = 2 * nnz * batch + 12 * nrows * batch
    return max(half_bytes(nrows, ncols, nnz, dtype, batch, half)
               / HBM_BYTES_PER_S, ops / FLOPS_PER_S[dtype])


def iteration_seconds(m: int, n: int, nnz: int, dtype: str,
                      batch: int = 1) -> float:
    """The least time of one iteration's two halves on an LP of m rows, n
    columns and nnz entries (batch members sharing A)."""
    return (half_seconds(n, m, nnz, dtype, batch, "x")
            + half_seconds(m, n, nnz, dtype, batch, "y"))
