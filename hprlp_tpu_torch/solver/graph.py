"""CUDA-graph capture of a solver step, kernel launch counts that see
replays, and probes timed on the device.

The solve loops (solver/device_loop.py, solver/batched_device_loop.py)
capture one chunk boundary, 150 iterations and the decision around them,
once per solve, and replay it; the reference captures its iterations the
same way (src/HPRLP.cu:99-114, 290-303).  A replay runs no Python, so the
kernel wrappers' launch counters (`fn.launches`) would see one chunk per
capture: `CapturedStep` records each wrapper's launches during the capture
and adds them on every replay, so a counter reads the number of times the
card ran the kernel, whichever route ran it.

Every capture of a process on a device warms up on one side stream of
that device (`warmup_stream`) and allocates from one graph memory pool
(`graph_pool`): PyTorch keeps a cuBLAS workspace per stream and a graph's
private pool until the allocator's cache is emptied, so a new stream or
pool per capture (the autotune's probes, each solve's chunk boundary,
each refinement stage) grew a long-lived process's device memory with
every solve.  The captures of one process run one after another and
replay on one stream, so they can share the pool: nothing a capture
leaves allocated is used after another capture of the pool replays.

`time_probe` times a probe (the autotune's chunks) by device time: on the
card, replays of a captured graph between CUDA events; on the CPU, where
the host is the device, eager calls by the wall clock.

A mesh solve's step holds the sharded SpMV's all-reduces
(ops/sparse.py::all_reduce_sum) or all-gathers (all_gather_rows): NCCL
collectives, which a graph captures like kernels.  Its capture runs in the "thread_local" error mode, so that
NCCL's watchdog thread, which queries its events while the step is being
captured, does not invalidate the capture.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.sparse import all_gather_rows, all_reduce_sum
from ..ops.spmm import csr_spmm, csr_spmm_rowwise, spmm_x_half, spmm_y_half
from ..ops.spmv import (csr_spmv, csr_spmv_rowgroup, group_sum_kernel,
                        spmv_x_half, spmv_y_half, tiled_half_epilogue,
                        tiled_spmv, tiled_x_half, tiled_x_half_block_x,
                        tiled_y_half, tiled_y_half_block_x)

# Every kernel wrapper on a solve path that counts its launches, the
# previous designs, which no solve path may launch (the row-group CSR
# kernel, the rowwise SpMM, the tiles' group-sum pass and their fused
# halves on block_x), and the sharded SpMV's collectives: the column
# shards' all-reduce, the row shards' all-gather.
COUNTED = {"tiled_spmv": tiled_spmv, "tiled_x_half": tiled_x_half,
           "tiled_y_half": tiled_y_half,
           "tiled_half_epilogue": tiled_half_epilogue, "csr_spmv": csr_spmv,
           "spmv_x_half": spmv_x_half, "spmv_y_half": spmv_y_half,
           "csr_spmm": csr_spmm, "spmm_x_half": spmm_x_half,
           "spmm_y_half": spmm_y_half, "csr_spmm_rowwise": csr_spmm_rowwise,
           "csr_spmv_rowgroup": csr_spmv_rowgroup,
           "group_sum_kernel": group_sum_kernel,
           "tiled_x_half_block_x": tiled_x_half_block_x,
           "tiled_y_half_block_x": tiled_y_half_block_x,
           "all_reduce_sum": all_reduce_sum,
           "all_gather_rows": all_gather_rows}

_WARMUP_STREAMS: dict[int, torch.cuda.Stream] = {}
_GRAPH_POOLS: dict[int, tuple] = {}  # device -> (pool, the graph keeping it)


def release_graph_pools() -> None:
    """Drop the graph pools of this process (and the graphs keeping them),
    so that torch.cuda.empty_cache can hand their memory back once no graph
    captured into them lives; the next capture makes a new pool."""
    _GRAPH_POOLS.clear()


def _index(device) -> int:
    device = torch.device("cuda") if device is None else torch.device(device)
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def warmup_stream(device=None) -> torch.cuda.Stream:
    """The side stream of `device` (default: the current one) on which
    every capture of this process warms up, made at its first use."""
    i = _index(device)
    if i not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[i] = torch.cuda.Stream(device=i)
    return _WARMUP_STREAMS[i]


def graph_pool(device=None) -> tuple:
    """The graph memory pool of `device` that every capture of this
    process allocates from, made at its first use.  A pool lives while a
    graph captured into it does, so the first capture, of one fill, is
    kept for the process: the pool and its free blocks outlive every later
    graph, and the next capture takes them."""
    i = _index(device)
    if i not in _GRAPH_POOLS:
        keeper = torch.cuda.CUDAGraph()
        with torch.cuda.device(i), torch.cuda.graph(keeper):
            torch.zeros(1, device=f"cuda:{i}")
        _GRAPH_POOLS[i] = (keeper.pool(), keeper)
    return _GRAPH_POOLS[i][0]


def launch_counts() -> dict[str, int]:
    """Each counted wrapper's launches so far."""
    return {name: fn.launches for name, fn in COUNTED.items()}


def _add(counts: dict | None, delta: dict) -> None:
    """Add `delta` to `counts`, or to the wrappers' own counters when
    `counts` is None."""
    for name, n in delta.items():
        if counts is None:
            COUNTED[name].launches += n
        else:
            counts[name] = counts.get(name, 0) + n


class CapturedStep:
    """fn() run once on the device's warm-up stream, then captured once in
    a CUDA graph from the device's graph pool; `replay()` runs the
    capture.  `out` holds what the captured
    call returned: tensors that each replay rewrites.  The warm-up's and
    each replay's launches are counted in `counts` when it is given (a
    probe's, kept apart from a solve's), else in the wrappers' own
    counters.  A failed capture raises.  capture_error_mode: torch.cuda.
    graph's ("thread_local" for a step with NCCL collectives)."""

    def __init__(self, fn, counts: dict | None = None,
                 capture_error_mode: str = "global"):
        self.counts = counts
        before = launch_counts()
        side = warmup_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        warm = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=graph_pool(),
                              capture_error_mode=capture_error_mode):
            self.out = fn()
        captured = launch_counts()
        # The capture ran nothing: the counters go back to what the
        # warm-up really launched, and each replay adds the capture's.
        for name, fn_ in COUNTED.items():
            fn_.launches = before[name]
        _add(counts, {k: warm[k] - before[k] for k in warm
                      if warm[k] != before[k]})
        self.per_replay = {k: captured[k] - warm[k] for k in captured
                           if captured[k] != warm[k]}

    def replay(self) -> None:
        self.graph.replay()
        _add(self.counts, self.per_replay)


def time_probe(fn, device: torch.device, reps: int = 3,
               counts: dict | None = None,
               capture_error_mode: str = "global"):
    """(seconds, output) of one fn() call.  On the card: fn captured in a
    CUDA graph (CapturedStep, launches counted in `counts`, in
    `capture_error_mode`), replayed once to warm up, then the least device
    time of `reps` replays between CUDA events; `output` is the last
    replay's.  On the CPU: the least wall time of `reps` eager calls after
    one to warm up."""
    if device.type == "cuda":
        step = CapturedStep(fn, counts=counts,
                            capture_error_mode=capture_error_mode)
        step.replay()
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            step.replay()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3)
        return best, step.out
    out = fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


class StepGraph:
    """A solver step captured once and replayed chunk after chunk.

    `step` has a `step()` method that advances its static buffers by one
    chunk boundary and writes that boundary's record into the tensor
    `step.row`.  `run` replays with a one-chunk lookahead: the replay of
    chunk k + 1 and the copy of its row into pinned host memory are
    queued before the host waits for chunk k's row, so the card never
    waits on the host, and at most one replay runs past the row that
    stops the run (the step must leave its buffers as they were then).
    `capture_s`: the warm-up and capture's seconds; `replay_host_s` and
    `replays`: the host's time in `CUDAGraph.replay` calls, and their
    number.  capture_error_mode: as CapturedStep's."""

    def __init__(self, step, n_rows: int,
                 capture_error_mode: str = "global"):
        t0 = time.perf_counter()
        self.step = step
        self.captured = CapturedStep(step.step,
                                     capture_error_mode=capture_error_mode)
        self.rows = torch.empty((n_rows, *step.row.shape),
                                dtype=step.row.dtype, pin_memory=True)
        torch.cuda.synchronize(step.row.device)
        self.capture_s = time.perf_counter() - t0
        self.replay_host_s = 0.0
        self.replays = 0

    def _launch(self, k: int) -> torch.cuda.Event:
        t0 = time.perf_counter()
        self.captured.replay()
        self.replay_host_s += time.perf_counter() - t0
        self.replays += 1
        self.rows[k].copy_(self.step.row, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return event

    def run(self, n_chunks: int, stop) -> list:
        """Replay up to n_chunks chunks; return their rows (float64 numpy
        arrays) up to and including the first for which stop(row) holds.
        A failed replay raises."""
        if not 1 <= n_chunks <= len(self.rows):
            raise ValueError(f"{n_chunks} chunks, room for {len(self.rows)}")
        events = [self._launch(0)]
        out = []
        for k in range(n_chunks):
            if k + 1 < n_chunks:
                events.append(self._launch(k + 1))
            events[k].synchronize()
            out.append(self.rows[k].numpy().astype(np.float64))
            if stop(out[-1]):
                break
        return out


def commit(keep: torch.Tensor, pairs) -> None:
    """Write each (buffer, new value) of `pairs` into its buffer, except
    where `keep` holds: there the buffer keeps its value.  Every selection
    is made before any write, so a new value may alias another buffer."""
    pairs = list(pairs)
    news = [torch.where(keep, buf, new) for buf, new in pairs]
    for (buf, _), new in zip(pairs, news):
        buf.copy_(new)
