"""Kernel timing on the card, and the SpMV's least time (its bound).

`time_ms` is device time by CUDA-graph replay between CUDA events;
`eager_ms` adds the host's launch gaps.  `spmv_bytes`/`spmv_bound` give
the least time one y = A x, or one Y = A X over B columns, can take on an
H100 SXM, `half_bytes`/`half_bound` that of one fused half-update (the
SpMM or the CSR kernel and its row write, csrc/spmm.cu, csrc/
spmv_csr.cu, and the tiles' fused halves, csrc/spmv_tiled.cu: the same
function) and `epilogue_bound` that of the mesh's epilogue alone: the
larger of its bytes over the HBM rate and its operations over the
vector-unit peak (NVIDIA's data sheet; both assume the 700 W power
limit).  `gather_bytes` is what the batched SpMM and its fused halves
gather from L2, X's row for every entry.  `l2_rotations` sizes a set of
input copies that keeps a timed call's inputs out of L2.
`tiled_half_bytes` is what a fused half on the tiles streams, padding
(and on the previous design the partials) included: a figure of the
layout, not a bound.
`PeakRss`
samples the host's resident set while a block runs.
"""

from __future__ import annotations

import os
import subprocess
import threading

import torch

HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
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


def l2_rotations(nbytes: int, fill: int = 4) -> int:
    """How many copies of a call's nbytes of inputs to take in turn, one a
    call, so that `fill` times the L2 passes between two calls on one copy:
    time_ms then sees its inputs come from HBM, as a call that follows a
    larger kernel does."""
    return max(2, -(-fill * L2_BYTES // max(nbytes, 1)))


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


def gather_bytes(A, dtype: torch.dtype, B: int) -> int:
    """Bytes the SpMM kernels of csrc/spmm.cu gather from L2 for one
    Y = A X with X of B columns: every stored entry's row of X, B values
    (nnz * B * itemsize, summed over the column slices).  The layout's
    cost, printed beside the function's least bytes (spmv_bytes,
    half_bytes), which bound it; divided by a kernel's time it is the L2
    rate that kernel implies."""
    return A.nnz * B * torch.empty((), dtype=dtype).element_size()


def _bound(nbytes: int, ops: int, dtype: torch.dtype) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of nbytes over the HBM rate and ops
    over the vector-unit peak of `dtype`, and which one it is."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FLOPS_PER_S[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def spmv_bound(A, dtype: torch.dtype, B: int = 1) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time of one Y = A X with X of B
    columns, and whether its bytes or its 2 * nnz * B operations set it."""
    return _bound(spmv_bytes(A, dtype, B), 2 * A.nnz * B, dtype)


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
    return _bound(half_bytes(A, dtype, B, half),
                  2 * A.nnz * B + 12 * A.nrows * B, dtype)


def tiled_half_bytes(T, dtype: torch.dtype, half: str,
                     stage: str | None = None) -> int:
    """Bytes one fused single-LP half streams on the tiles T (A^T's for
    the x-half) on `stage` (default: ops/spmv.py MAIN_STAGE): the tiles'
    padded value/key stream, their runs and row starts, the gathered
    operand's strips (x once), the half's row vectors read and written,
    the scalar and counter, and on block_x (the previous design) with G >
    1 strip groups the G partials written to HBM and read back; the main
    stage sums them in distributed shared memory.  The layout's cost
    beside the function's least bytes (half_bytes), which bound the
    half."""
    from ..ops.spmv import MAIN_STAGE

    v = torch.empty((), dtype=dtype).element_size()
    through_hbm = T.n_groups > 1 and (stage or MAIN_STAGE) != MAIN_STAGE
    partials = 2 * T.n_groups * T.nrows * v if through_hbm else 0
    return (T.vals.shape[0] * (v + 4)
            + (T.runs.numel() + T.row_start.numel()) * 4 + T.ncols * v
            + HALF_ROW_TENSORS[half] * T.nrows * v + partials + v + 4)


def epilogue_bound(nrows: int, dtype: torch.dtype, half: str
                   ) -> tuple[float, str]:
    """(bound_ms, bound_by) of the mesh's epilogue over nrows rows: the
    summed product and the half's row vectors read and written once, the
    scalar and counter, against ~12 operations per row."""
    v = torch.empty((), dtype=dtype).element_size()
    return _bound((1 + HALF_ROW_TENSORS[half]) * nrows * v + v + 4,
                  12 * nrows, dtype)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


class PeakRss:
    """The peak resident set of this process while the `with` block runs,
    in bytes (`peak_bytes`, and `start_bytes` at entry), read by a thread
    from /proc/self/statm every `every` seconds.  Sampled, because not
    every kernel keeps a per-process high-water mark that starts anew at
    exec (VmHWM; gVisor has none), and ru_maxrss carries a launched
    process's parent's peak across fork and exec."""

    def __init__(self, every: float = 0.02):
        self.every = every
        self.start_bytes = self.peak_bytes = 0
        self._stop = threading.Event()
        self._thread = None

    @staticmethod
    def rss_bytes() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _sample(self):
        while not self._stop.wait(self.every):
            self.peak_bytes = max(self.peak_bytes, self.rss_bytes())

    def __enter__(self) -> "PeakRss":
        self.start_bytes = self.peak_bytes = self.rss_bytes()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_bytes = max(self.peak_bytes, self.rss_bytes())
        return False
