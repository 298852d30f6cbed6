"""Where the solve loop's device time goes: torch.profiler over whole
chunks of run_superchunk on the card.

    python -m hprlp_tpu_torch.prof.prof_loop [--size large|huge|assign64]
                                             [--dtype f32|f64]

Sets the LP up as solve_problem does (layout and tiles, scaling, power
method), runs one warm-up chunk, times CHUNKS chunks unprofiled (stop_tol
0, so none stops early), then profiles CHUNKS more and prints per HPR
iteration: unprofiled it/s, host wall us, device us (kernel rows only),
the device's busy share (device time over wall time), kernels launched,
the SpMV kernels' share of device time, and the top kernels by device
time; with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..ops.device_problem import attach_tiles, build_device_problem
from ..ops.tiles import build_tiles
from ..params import Parameters
from ..solver.chunk import init_state, initial_metrics
from ..solver.device_loop import init_restart_dev, run_superchunk
from ..solver.power_iteration import power_method
from ..solver.scaling import scale_problem
from .problems import assignment_problem, random_lp
from .timing import card

SIZES = {"large": lambda: random_lp(65536, 131072, 20, seed=2),
         "huge": lambda: random_lp(262144, 524288, 40, seed=4),
         "assign64": lambda: assignment_problem(64)}
CHUNKS = 2
SPMV_KERNELS = ("tiled_spmv_kernel", "group_sum_kernel")


class Loop:
    """The solver's device state for one LP, advanced chunk by chunk."""

    def __init__(self, problem, dtype):
        dev = torch.device("cuda")
        self.check = Parameters().check_iter
        raw, _ = build_device_problem(problem, dtype=dtype, device=dev)
        tiles = (build_tiles(raw.A), build_tiles(raw.AT))
        lp, self.scal = scale_problem(raw)
        self.lp = attach_tiles(lp, *tiles)
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

    def run(self, n_chunks: int) -> None:
        (self.state, self.rd, self.sigma, self.lam, self.metrics, _, k,
         self.best) = run_superchunk(
            self.lp, self.scal, self.state, self.rd, self.sigma, self.lam,
            self.metrics, self.it, self.obj_c, 0.0, n_chunks, self.check, 0,
            self.best)
        self.it += k * self.check


def _device_us(event) -> float:
    return float(getattr(event, "device_time_total",
                         getattr(event, "cuda_time_total", 0.0)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", choices=sorted(SIZES), default="huge")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_loop: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    loop = Loop(SIZES[args.size](), dtype)
    loop.run(1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run(CHUNKS)
    torch.cuda.synchronize()
    iters = CHUNKS * loop.check
    its = iters / (time.perf_counter() - t0)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loop.run(CHUNKS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(_device_us(e) for e in kernels)
    spmv_us = sum(_device_us(e) for e in kernels
                  if any(k in e.key for k in SPMV_KERNELS))
    launches = sum(e.count for e in kernels)
    head = f"{args.size} {args.dtype}"
    print(f"{head}: {its:.1f} it/s unprofiled; profiled {iters} iterations: "
          f"wall {wall_us / iters:.1f} us/it, device {device_us / iters:.1f} "
          f"us/it, busy share {device_us / wall_us:.3f}, "
          f"{launches / iters:.1f} kernels/it, SpMV {spmv_us / 1e3:.2f} of "
          f"{device_us / 1e3:.2f} ms ({spmv_us / max(device_us, 1e-9):.1%}) "
          f"[{name}]", flush=True)
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        print(f"{head}:   {_device_us(e) / iters:8.2f} us/it  {e.count:6d}x  "
              f"{e.key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
