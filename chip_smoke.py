"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CSR SpMV kernel from the checkout's sources, holds it against
its plain PyTorch version at the main path's shapes, then drives the main
path (hprlp_tpu_torch.solve) on three LPs:

  1. toolchain   nvidia-smi name/power limit, torch, CUDA, nvcc, Triton
  2. build       the kernel library (nvcc, sm_90a), with its build time
  3. kernel      f32 and f64 kernel against spmv_reference on A and A^T of
                 random_lp(65536, 131072, 20, seed=2), with timings
  4. main f32    solve of that LP at stop_tol=1e-4 (auto -> f32 on CUDA)
  5. main f64    assignment_problem(64) at 1e-8 (auto -> f64), objective
                 against scipy's linear_sum_assignment
  6. real size   random_lp(262144, 524288, 40, seed=4), 10.5M nnz, at 1e-4

Any failure raises (exit code != 0).  The line before the last is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
Needs torch, numpy and scipy only; imports neither JAX nor hprlp_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def random_lp(m, n, nnz_per_row, seed=0, name=""):
    """Copy of benchmarks/run.py::random_lp (pinned by a CPU test)."""
    from hprlp_tpu_torch.problem import LpProblem

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), nnz_per_row)
    cols = rng.integers(0, n, size=m * nnz_per_row)
    vals = rng.normal(size=m * nnz_per_row)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    x_feas = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x_feas
    return LpProblem.from_arrays(A, Ax - 1.0, Ax + 1.0, x_feas - 2.0,
                                 x_feas + 2.0, rng.normal(size=n),
                                 name=name or f"random{m}x{n}")


def assignment_problem(n=64, seed=0):
    """Copy of benchmarks/run.py::assignment_problem (pinned by a CPU
    test): LP relaxation of an n x n assignment problem."""
    from hprlp_tpu_torch.problem import LpProblem

    rng = np.random.default_rng(seed)
    cost = rng.uniform(0.0, 1.0, (n, n))
    rows, cols, vals = [], [], []
    for i in range(n):          # row-sum constraints
        for j in range(n):
            rows.append(i)
            cols.append(i * n + j)
            vals.append(1.0)
    for j in range(n):          # col-sum constraints
        for i in range(n):
            rows.append(n + j)
            cols.append(i * n + j)
            vals.append(1.0)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(2 * n, n * n)).tocsr()
    ones = np.ones(2 * n)
    return LpProblem.from_arrays(A, ones, ones, np.zeros(n * n),
                                 np.ones(n * n), cost.ravel(),
                                 name=f"assignment{n}")


def phase(n, text):
    print(f"[phase {n}] {text}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps=50):
    """Device time of one fn() call: reps calls captured in a CUDA graph
    and replayed between two CUDA events, so host launch gaps are out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def eager_ms(fn, reps=50):
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


def toolchain():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    from hprlp_tpu_torch.ops.spmv import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(card, flush=True)
    phase(1, f"card={card!r} torch={torch.__version__} "
             f"cuda={torch.version.cuda} nvcc={nvcc!r} triton={triton_v}")
    return card


def kernel_check(card):
    from hprlp_tpu_torch.ops.device_problem import build_device_problem
    from hprlp_tpu_torch.ops.spmv import csr_spmv, spmv_reference

    problem = random_lp(65536, 131072, 20, seed=2)
    rng = np.random.default_rng(0)
    records = {}
    for dtype, rtol, tag in ((torch.float32, 1e-5, "f32"),
                             (torch.float64, 1e-12, "f64")):
        lp, _ = build_device_problem(problem, dtype=dtype, device="cuda")
        rec = {}
        for mat_name, M in (("A", lp.A), ("AT", lp.AT)):
            x = torch.as_tensor(rng.normal(size=M.ncols), device="cuda"
                                ).to(dtype)
            y = csr_spmv(M, x)
            y_ref = spmv_reference(M, x)
            torch.cuda.synchronize()
            scale = float(y_ref.abs().max())
            err = float((y - y_ref).abs().max())
            check(err <= rtol * scale,
                  f"{tag} {mat_name}: max abs err {err} > {rtol} * {scale}")
            rec[mat_name] = {
                "err": err, "scale": scale,
                "ms": time_ms(lambda: csr_spmv(M, x)),
                "plain_ms": time_ms(lambda: spmv_reference(M, x)),
                "eager_ms": eager_ms(lambda: csr_spmv(M, x))}
        records[tag] = rec
        phase(3, f"{tag}: " + "; ".join(
            f"{k} ({lp.A.nnz} nnz) max_abs_err={v['err']:.3e} "
            f"(<= {rtol:g}*{v['scale']:.3e}) kernel={v['ms']:.4f} ms "
            f"plain={v['plain_ms']:.4f} ms (graph replay; eager kernel "
            f"{v['eager_ms']:.4f} ms)" for k, v in rec.items())
            + f" [{card}]")
    return records


def run_solve(n, problem, params, card):
    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch.ops.spmv import csr_spmv

    csr_spmv.launches = 0
    res = hp.solve(problem.A, problem.AL, problem.AU, problem.l, problem.u,
                   problem.c, params, obj_constant=problem.obj_constant)
    launches = csr_spmv.launches
    kkt = problem.kkt_error(res.x, res.y, res.z)["kkt"]
    its = res.iter / res.time if res.time > 0 else float("nan")
    phase(n, f"{problem.name}: status={res.status} iter={res.iter} "
             f"setup={res.setup_time:.3f}s scaling={res.scaling_time:.3f}s "
             f"power={res.power_time:.3f}s solve={res.time:.3f}s "
             f"it/s={its:.1f} launches={launches} "
             f"primal_obj={res.primal_obj:.10e} kkt_f64={kkt:.3e} [{card}]")
    check(launches > 0, f"phase {n}: the CSR kernel was never launched")
    check(res.status == "OPTIMAL", f"phase {n}: status {res.status}")
    return res, kkt, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import hprlp_tpu_torch
    from hprlp_tpu_torch import Parameters
    from hprlp_tpu_torch.ops import spmv as spmv_mod

    pkg_dir = os.path.dirname(os.path.abspath(hprlp_tpu_torch.__file__))
    check(os.path.dirname(pkg_dir) == HERE,
          f"hprlp_tpu_torch imported from {pkg_dir}, not this checkout")
    check("jax" not in sys.modules and "hprlp_tpu" not in sys.modules,
          "the port imported JAX")

    card = toolchain()

    t0 = time.perf_counter()
    lib = spmv_mod.build()
    phase(2, f"built {os.path.relpath(lib, HERE)} in "
             f"{time.perf_counter() - t0:.2f} s")

    rec = kernel_check(card)

    res4, kkt4, l32a = run_solve(
        4, random_lp(65536, 131072, 20, seed=2),
        Parameters(stop_tol=1e-4, verbose=False, max_iter=100_000), card)
    check(kkt4 < 1e-3, f"phase 4: host f64 KKT {kkt4}")

    prob5 = assignment_problem(64)
    res5, _, l64 = run_solve(5, prob5, Parameters(
        stop_tol=1e-8, verbose=False, max_iter=100_000), card)
    from scipy.optimize import linear_sum_assignment

    cost = prob5.c.reshape(64, 64)
    r, c = linear_sum_assignment(cost)
    exact = float(cost[r, c].sum())
    rel = abs(res5.primal_obj - exact) / abs(exact)
    phase(5, f"linear_sum_assignment={exact:.10e} rel_err={rel:.3e}")
    check(rel < 1e-6, f"phase 5: objective off by {rel}")

    res6, kkt6, l32b = run_solve(
        6, random_lp(262144, 524288, 40, seed=4),
        Parameters(stop_tol=1e-4, verbose=False, max_iter=50_000), card)
    check(kkt6 < 1e-3, f"phase 6: host f64 KKT {kkt6}")

    src = os.path.relpath(spmv_mod.SOURCE, HERE)
    kernels = []
    for tag, launches, replaces, also in (
            ("f32", l32a + l32b, "hprlp_tpu/ops/pallas_spmv.py:67",
             "hprlp_tpu/ops/pallas_spmv.py:272"),
            ("f64", l64, "hprlp_tpu/ops/pallas_spmv.py:178",
             "hprlp_tpu/ops/pallas_spmv.py:394")):
        a, at = rec[tag]["A"], rec[tag]["AT"]
        kernels.append({
            "name": f"csr_spmv_{tag}", "route": "cuda", "source": src,
            "replaces": replaces, "also_replaces": also,
            "launches": launches,
            "max_abs_err": max(a["err"], at["err"]),
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "ms_AT": at["ms"], "plain_ms_AT": at["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
