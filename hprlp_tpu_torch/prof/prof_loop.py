"""Where the solve loop's device time goes: torch.profiler over whole
chunks of run_superchunk (or, with --batch, run_batched_superchunk) on the
card.

    python -m hprlp_tpu_torch.prof.prof_loop [--size large|huge|assign64]
                                             [--dtype f32|f64] [--batch B]
                                             [--backend tiled|gather]
                                             [--eager]

Sets the LP up as solve_problem does (layout and tiles, scaling, power
method, the chunk boundary captured in a CUDA graph), runs one warm-up
chunk, times CHUNKS chunks unprofiled (stop_tol 0, so none stops early),
then profiles CHUNKS more and prints per HPR iteration: unprofiled it/s,
host wall us, device us (kernel rows only), the device's busy share
(device time over wall time), kernels launched, the sparse-product
kernels' share of device time, and the top kernels by device time; with
the card's name and power limit.  The chunks are the graph's replays, as
the solve runs them; --eager runs the same steps eagerly instead.  --batch B sets up B
members that share one A as solve_batched does (--size large is
prof.problems.batched_lp(65536, 131072, B, seed=3), huge
batched_lp(262144, 524288, B, seed=4)), and the share is the SpMM
kernel's.  --backend gather runs the single-LP loop on the CSR kernel.
On either backend the middle iterations' halves run fused into the SpMV
kernel (on tiles of several strip groups, into the group sum that follows
it), so the SpMV share counts the halves' updates, and a share taken
while they ran as plain ops did not; it counts the tiles' group sums too.
A column-sharded mesh's epilogue (half_epilogue_kernel) is not an SpMV
kernel and stays outside it.  `ChunkReplay` replays one chunk of an
LP a solve has already laid out, for `profile` where the LP is too large
to set up a second time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops.device_problem import attach_tiles, build_device_problem
from ..solver.autotune import set_spmv_backend
from ..ops.tiles import build_tiles
from ..params import Parameters
from ..solver import batched
from ..solver.batched_device_loop import (init_batched_restart_dev,
                                          run_batched_superchunk)
from ..solver.chunk import init_state, initial_metrics, run_chunk
from ..solver.graph import CapturedStep
from ..solver.batched_device_loop import capture_batched_superchunk
from ..solver.device_loop import (capture_superchunk, init_restart_dev,
                                  run_superchunk)
from ..solver.power_iteration import power_method
from ..solver.scaling import scale_problem
from .problems import assignment_problem, batched_lp, random_lp
from .timing import card

SIZES = {"large": lambda: random_lp(65536, 131072, 20, seed=2),
         "huge": lambda: random_lp(262144, 524288, 40, seed=4),
         "assign64": lambda: assignment_problem(64)}
BATCHED_SIZES = {"large": lambda B: batched_lp(65536, 131072, B, seed=3),
                 "huge": lambda B: batched_lp(262144, 524288, B, seed=4)}
CHUNKS = 2
# The most chunks one run() call replays.
MAX_CHUNKS = 8
# The SpMV kernels, with or without a fused half-update (csrc/spmv_tiled.cu:
# the main stage's cluster kernel, the previous design's kernel and group
# sum; csrc/spmv_csr.cu).
SPMV_KERNELS = ("tiled_cluster_kernel", "tiled_spmv_kernel",
                "group_sum_kernel", "csr_spmv_kernel")
# The SpMM kernels of csrc/spmm.cu: the product, with or without the
# fused x-half, and the y-half's ring kernel.
SPMM_KERNELS = ("csr_spmm_kernel", "spmm_y_ring_kernel")


class Loop:
    """The solver's device state for one LP, advanced chunk by chunk by the
    replays of its captured chunk boundary (graph=False: eagerly), with
    its SpMV on `backend` ("tiled" or "gather", autotune.set_spmv_backend)."""

    def __init__(self, problem, dtype, graph: bool = True,
                 backend: str = "tiled"):
        dev = torch.device("cuda")
        self.check = Parameters().check_iter
        raw, _ = build_device_problem(problem, dtype=dtype, device=dev)
        tiles = (build_tiles(raw.A), build_tiles(raw.AT))
        lp, self.scal = scale_problem(raw)
        self.lp = set_spmv_backend(attach_tiles(lp, *tiles), backend)
        lam = max(float(power_method(self.lp)) * 1.01, 1e-12)
        nb, nc = float(self.scal.norm_b), float(self.scal.norm_c)
        sigma = nb / nc if nb > 1e-8 and nc > 1e-8 else 1.0
        self.state = init_state(self.lp)
        self.rd = init_restart_dev(sigma, dtype, dev)
        self.sigma = torch.tensor(sigma, dtype=dtype, device=dev)
        self.lam = torch.tensor(lam, dtype=dtype, device=dev)
        self.metrics = initial_metrics(self.lp, self.scal, self.state)
        self.obj_c = torch.tensor(problem.obj_constant, dtype=dtype,
                                  device=dev)
        self.best = None
        self.it = 0
        self.graph = graph and capture_superchunk(
            self.lp, self.scal, self.state, self.rd, self.sigma, self.lam,
            self.metrics, self.obj_c, 0.0, self.check, 0, MAX_CHUNKS)

    def run(self, n_chunks: int) -> None:
        (self.state, self.rd, self.sigma, self.lam, self.metrics, _, k,
         self.best) = run_superchunk(
            self.lp, self.scal, self.state, self.rd, self.sigma, self.lam,
            self.metrics, self.it, self.obj_c, 0.0, n_chunks, self.check, 0,
            self.best, self.graph)
        self.it += k * self.check


class ChunkReplay:
    """One chunk of run_chunk (check_iter iterations) on an LP a solve has
    laid out (lp, scal: its ingest), from the zero state at sigma and
    lambda 1, captured once; run(n) replays it n times.  The SpMV kernels'
    work does not depend on the iterates, so this times an iteration as
    the solve runs it."""

    def __init__(self, lp, scal):
        dtype, dev = lp.c.dtype, lp.c.device
        self.check = Parameters().check_iter
        one = torch.ones((), dtype=dtype, device=dev)
        args = (lp, scal, init_state(lp), one, one,
                torch.tensor(False, device=dev), self.check)
        self.step = CapturedStep(lambda: run_chunk(*args), counts={})

    def run(self, n_chunks: int) -> None:
        for _ in range(n_chunks):
            self.step.replay()


class BatchedLoop:
    """The batched solver's device state for B members sharing one A,
    advanced chunk by chunk (every member stays active) by the replays of
    its captured chunk boundary (graph=False: eagerly)."""

    def __init__(self, arrays, dtype, device="cuda", graph: bool = True):
        dev = torch.device(device)
        params = Parameters()
        self.check = params.check_iter
        A, C, AL, AU, l, u = arrays
        su = batched.setup_batched(A, *(np.asarray(v, np.float64)
                                        for v in (C, AL, AU, l, u)),
                                   params, dev, dtype)
        self.lp, self.row_norm, self.col_norm = su.lp, su.row_norm, \
            su.col_norm
        B = C.shape[1]
        lam = max(float(power_method(su.lp0)) * 1.01, 1e-12)

        def tensor(v):
            return torch.as_tensor(v, device=dev).to(dtype)

        self.sigma = tensor(batched.initial_sigma(su))
        self.lam = tensor(np.full(B, lam))
        self.scales = tuple(tensor(v) for v in (
            su.b_scale, su.c_scale, su.norm_b_org, su.norm_c_org,
            np.zeros(B)))
        self.state = batched.init_batched_state(self.lp)
        self.rd = init_batched_restart_dev(self.sigma, dtype)
        self.active = torch.ones(B, dtype=torch.bool, device=dev)
        self.metrics = batched.initial_bmetrics(self.lp, self.row_norm,
                                                self.col_norm, self.state)
        self.it = 0
        self.graph = graph and capture_batched_superchunk(
            self.lp, self.row_norm, self.col_norm, self.state, self.rd,
            self.sigma, self.lam, self.active, self.metrics, *self.scales,
            0.0, self.check, MAX_CHUNKS)

    def run(self, n_chunks: int) -> None:
        (self.state, self.rd, self.sigma, self.lam, self.active,
         self.metrics, _, k) = run_batched_superchunk(
            self.lp, self.row_norm, self.col_norm, self.state, self.rd,
            self.sigma, self.lam, self.active, self.metrics, self.it,
            *self.scales, 0.0, n_chunks, self.check, self.graph)
        self.it += k * self.check


def _device_us(event) -> float:
    return float(getattr(event, "device_time_total",
                         getattr(event, "cuda_time_total", 0.0)))


def profile(loop, product_kernels, chunks: int = CHUNKS) -> dict:
    """One warm-up chunk, `chunks` timed unprofiled, `chunks` profiled.
    Per HPR iteration: its (unprofiled it/s), wall_us, device_us (kernel
    rows only), busy (device over wall time), kernels, and product_share,
    the share of device time in kernels whose names hold one of
    `product_kernels`; top: the 8 kernels of most device time as
    (us/it, count, name)."""
    loop.run(1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run(chunks)
    torch.cuda.synchronize()
    iters = chunks * loop.check
    its = iters / (time.perf_counter() - t0)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loop.run(chunks)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(_device_us(e) for e in kernels)
    product_us = sum(_device_us(e) for e in kernels
                     if any(k in e.key for k in product_kernels))
    return {"iters": iters, "its": its, "wall_us": wall_us / iters,
            "device_us": device_us / iters, "busy": device_us / wall_us,
            "kernels": sum(e.count for e in kernels) / iters,
            "product_us": product_us / iters,
            "product_share": product_us / max(device_us, 1e-9),
            "top": [(_device_us(e) / iters, e.count, e.key[:90]) for e in
                    sorted(kernels, key=_device_us, reverse=True)[:8]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", choices=sorted(SIZES), default="huge")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--batch", type=int, default=0, metavar="B",
                    help="profile the batched loop with B members")
    ap.add_argument("--backend", choices=("tiled", "gather"),
                    default="tiled", help="the single-LP loop's SpMV")
    ap.add_argument("--eager", action="store_true",
                    help="run the chunk boundaries eagerly, not as the "
                         "replays of their CUDA graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_loop: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    if args.batch:
        if args.size not in BATCHED_SIZES:
            ap.error(f"--batch takes --size {' or '.join(BATCHED_SIZES)}")
        loop = BatchedLoop(BATCHED_SIZES[args.size](args.batch), dtype,
                           graph=not args.eager)
        what, product = "SpMM", SPMM_KERNELS
        head = f"{args.size} B={args.batch} {args.dtype}"
    else:
        loop = Loop(SIZES[args.size](), dtype, graph=not args.eager,
                    backend=args.backend)
        what, product = "SpMV", SPMV_KERNELS
        head = f"{args.size} {args.dtype} {args.backend}"
    r = profile(loop, product)
    head += " eager" if args.eager else " graph"
    print(f"{head}: {r['its']:.1f} it/s unprofiled; profiled {r['iters']} "
          f"iterations: wall {r['wall_us']:.1f} us/it, device "
          f"{r['device_us']:.1f} us/it, busy share {r['busy']:.3f}, "
          f"{r['kernels']:.1f} kernels/it, {what} {r['product_us']:.1f} of "
          f"{r['device_us']:.1f} us/it ({r['product_share']:.1%}) [{name}]",
          flush=True)
    for us, count, key in r["top"]:
        print(f"{head}:   {us:8.2f} us/it  {count:6d}x  {key}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
