"""Kernel timing on the card, and the SpMV's least time (its bound).

`time_ms` is device time by CUDA-graph replay between CUDA events;
`eager_ms` adds the host's launch gaps.  `spmv_bytes`/`spmv_bound` give
the least time one y = A x, or one Y = A X over B columns, can take on an
H100 SXM, and `half_bytes`/`half_bound` that of one fused batched
half-update (the SpMM and its row write, csrc/spmm.cu): the larger of its
bytes over the HBM rate and its operations over the vector-unit peak
(NVIDIA's data sheet; both assume the 700 W power limit).
"""

from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
# Non-tensor-core peaks: 67 TFLOP/s in f32, 34 TFLOP/s in f64.
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}


def time_ms(fn, reps: int = 50) -> float:
    """Device time of one fn() call: reps calls captured in a CUDA graph
    (warmed up and pooled as the solver's captures, solver/graph.py) and
    replayed between two CUDA events, so host launch gaps are out."""
    from ..solver.graph import graph_pool, warmup_stream

    side = warmup_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=graph_pool()):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def eager_ms(fn, reps: int = 50) -> float:
    """Time per call of reps back-to-back eager calls (host launch gaps
    included), by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def spmv_bytes(A, dtype: torch.dtype, B: int = 1) -> int:
    """Bytes one Y = A X with X of B columns (B = 1: y = A x) must move:
    values, column indices (int32), indptr (int32), X and Y, each once."""
    v = torch.empty((), dtype=dtype).element_size()
    return (A.nnz * (v + 4) + (A.nrows + 1) * 4
            + B * (A.ncols + A.nrows) * v)


def spmv_bound(A, dtype: torch.dtype, B: int = 1) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time of one Y = A X with X of B
    columns, and whether its bytes or its 2 * nnz * B operations set it."""
    bytes_ms = spmv_bytes(A, dtype, B) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * A.nnz * B / FLOPS_PER_S[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


# The (rows, B) tensors a fused half reads or writes besides its gathered
# operand: the x-half reads x, last_x, c, l, u and writes x and x_hat; the
# y-half reads y, last_y, AL, AU and writes y (csrc/spmm.cu).
HALF_ROW_TENSORS = {"x": 7, "y": 5}


def half_bytes(A, dtype: torch.dtype, B: int, half: str) -> int:
    """Bytes one fused middle-iteration half must move over A's rows
    (A^T's for the x-half): the SpMM's entries, indptr and gathered operand
    once each, its (nrows, B) iterates, bounds and outputs, and the (B,)
    scalar, counter and mask of every member."""
    v = torch.empty((), dtype=dtype).element_size()
    return (A.nnz * (v + 4) + (A.nrows + 1) * 4 + B * A.ncols * v
            + HALF_ROW_TENSORS[half] * B * A.nrows * v + B * (v + 4 + 1))


def half_bound(A, dtype: torch.dtype, B: int, half: str
               ) -> tuple[float, str]:
    """(bound_ms, bound_by) of one fused half: its bytes over the HBM rate
    against its 2 * nnz * B multiply-adds and ~12 operations per (row,
    member) of the update over the vector-unit peak."""
    bytes_ms = half_bytes(A, dtype, B, half) / HBM_BYTES_PER_S * 1e3
    ops_ms = (2 * A.nnz * B + 12 * A.nrows * B) / FLOPS_PER_S[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]
