"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from the checkout's sources, holds each against its
plain PyTorch version at its path's shapes, drives the main path
(hprlp_tpu_torch.solve) on three LPs, then the SpMV variant studies:

  1. toolchain   nvidia-smi name/power limit, torch, CUDA, nvcc, Triton
  2. build       both kernel libraries (nvcc, sm_90a, one process per
                 source, started together), with their build times
  3. kernel      f32 and f64 CSR kernel against spmv_reference on A and A^T
                 of random_lp(65536, 131072, 20, seed=2), with timings, the
                 bound and torch.mv on a sparse CSR tensor (cuSPARSE) as
                 the library yardstick
  4. main f32    solve of that LP at stop_tol=1e-4 (auto -> f32 on CUDA)
  5. main f64    assignment_problem(64) at 1e-8 (auto -> f64), objective
                 against scipy's linear_sum_assignment
  6. real size   random_lp(262144, 524288, 40, seed=4), 10.5M nnz, at 1e-4
  7. variants    the four prof_* studies (hprlp_tpu_torch/prof/) on the
                 bench LP (A, A^T) and on phase 6's LP (A), every variant
                 against its plain version and the exact ones against A @ x

Any failure raises (exit code != 0).  The line before the last is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
Needs torch, numpy and scipy only; imports neither JAX nor hprlp_tpu.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hprlp_tpu_torch.prof.problems import (assignment_problem, make_problem,
                                           random_lp)
from hprlp_tpu_torch.prof.timing import card as card_name
from hprlp_tpu_torch.prof.timing import eager_ms, spmv_bound, time_ms

HERE = os.path.dirname(os.path.abspath(__file__))


def phase(n, text):
    print(f"[phase {n}] {text}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def library_call(M, x):
    """torch.mv on a sparse CSR tensor (cuSPARSE), the yardstick of the
    CSR kernels: timed here, never called by the port."""
    S = torch.sparse_csr_tensor(M.indptr, M.indices, M.vals,
                                (M.nrows, M.ncols))
    return lambda: torch.mv(S, x)


def toolchain():
    card = card_name()
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
            bound_ms, bound_by = spmv_bound(M, dtype)
            rec[mat_name] = {
                "err": err, "scale": scale,
                "ms": time_ms(lambda: csr_spmv(M, x)),
                "plain_ms": time_ms(lambda: spmv_reference(M, x)),
                "library_ms": time_ms(library_call(M, x)),
                "eager_ms": eager_ms(lambda: csr_spmv(M, x)),
                "bound_ms": bound_ms, "bound_by": bound_by}
        records[tag] = rec
        phase(3, f"{tag}: " + "; ".join(
            f"{k} ({lp.A.nnz} nnz) max_abs_err={v['err']:.3e} "
            f"(<= {rtol:g}*{v['scale']:.3e}) kernel={v['ms']:.4f} ms "
            f"plain={v['plain_ms']:.4f} ms library={v['library_ms']:.4f} ms "
            f"bound={v['bound_ms']:.4f} ms ({v['bound_by']}, "
            f"{v['bound_ms'] / v['ms']:.1%}) (graph replay; eager kernel "
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


def build_kernels():
    """Build every kernel library at once, one nvcc process per source.
    Returns {source: (library, seconds, nvcc -Xptxas -v output)}."""
    from hprlp_tpu_torch.ops import spmv, spmv_variants

    sources = (spmv.SOURCE, spmv_variants.SOURCE)
    logs = {src: [] for src in sources}

    def one(src):
        t0 = time.perf_counter()
        lib = spmv.build(src, logs[src])
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(one, sources)))
    return {src: (*built[src], "".join(logs[src])) for src in sources}


def ptxas_summary(log):
    """One line per kernel from nvcc -Xptxas -v: registers and spills."""
    kernels, order, name = {}, [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
            if name not in kernels:
                kernels[name] = []
                order.append(name)
        elif name and ("spill" in line or "Used" in line):
            kernels[name].append(line.split(":", 1)[-1].strip())
    pretty = dict(zip(order, order))
    if order and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(order),
                             capture_output=True, text=True).stdout
        pretty = {k: v.replace("(anonymous namespace)::", "").split("(")[0]
                  .removeprefix("void ")
                  for k, v in zip(order, out.splitlines())}
    return [f"{pretty[k]}: {'; '.join(kernels[k])}" for k in order]


# Each family's headline variant (exact) for the kernels' JSON record, and
# the Pallas study it replaces (make_kernel; spmv_loop; pallas_call).
HEADLINE = {"ablate": "full", "multi_acc": "n_acc=1", "flush": "full",
            "segsum": "full"}
REPLACES = {
    "ablate": ("benchmarks/prof_lane_ablate.py:44", ":90", ":115"),
    "multi_acc": ("benchmarks/prof_dual_acc.py:32", ":60", ":87"),
    "flush": ("benchmarks/prof_flush_variants.py:46", ":97", ":122"),
    "segsum": ("benchmarks/prof_kernel_variants.py:39", ":121", ":152"),
}


def variants_phase(card, built, huge_problem):
    """Phase 7: the variant-study path at the bench LP (A, A^T) and at
    phase 6's LP (A).  Returns the four families' JSON records."""
    from hprlp_tpu_torch.ops import spmv_variants as sv
    from hprlp_tpu_torch.prof import (prof_dual_acc, prof_flush_variants,
                                      prof_kernel_variants, prof_lane_ablate,
                                      study)

    lib, secs, log = built[sv.SOURCE]
    phase(7, f"built {os.path.relpath(lib, HERE)} in {secs:.2f} s "
             f"(beside the CSR kernel's build)")
    for line in ptxas_summary(log):
        phase(7, f"ptxas {line}")
    sizes = {"bench": study.device_matrices(make_problem()),
             "huge": {"A": study.device_matrices(huge_problem)["A"]}}
    modules = (prof_lane_ablate, prof_dual_acc, prof_flush_variants,
               prof_kernel_variants)

    for wrapper in sv.WRAPPERS.values():
        wrapper.launches = 0
    timings = {(m.FAMILY, size): m.run(mats)
               for m in modules for size, mats in sizes.items()}
    launches = {fam: w.launches for fam, w in sv.WRAPPERS.items()}

    library = {}
    for size, mats in sizes.items():
        for mat, M in mats.items():
            library[size, mat] = time_ms(library_call(M, study.study_x(M)))
            phase(7, f"{size} {mat}: torch.mv on sparse CSR (cuSPARSE) "
                     f"{library[size, mat] * 1e3:.3f} us [{card}]")
    records, failed = [], []
    for m in modules:
        fam = m.FAMILY
        checks = []
        for size, mats in sizes.items():
            got = study.check(fam, mats, m.VARIANTS)
            checks += [dict(c, size=size) for c in got]
            for line in study.report(timings[fam, size], got, card, size):
                phase(7, line)
        failed += [f"{fam}/{c['size']}/{c['matrix']}/{c['variant']}"
                   for c in checks if not c["ok"]]
        check(launches[fam] > 0, f"phase 7: {fam} was never launched")
        head = HEADLINE[fam]
        M = sizes["bench"]["A"]
        x = study.study_x(M)
        t = {(r["matrix"], r["variant"], size): r
             for (f, size), recs in timings.items() if f == fam for r in recs}
        bench_a = t["A", head, "bench"]
        variants = {}
        for name in m.VARIANTS:
            v = sv.variant(fam, name)
            errs = [c for c in checks if c["variant"] == name]
            variants[name] = {
                "kind": v.kind,
                "ms": {f"{size}_{mat}": t[mat, name, size]["ms"]
                       for size, mats in sizes.items() for mat in mats},
                "max_abs_err": max(c["err"] for c in errs),
                "tol_abs": min(c["tol"] * c["scale"] for c in errs)}
        records.append({
            "name": f"spmv_{fam}", "route": "cuda",
            "source": os.path.relpath(sv.SOURCE, HERE),
            "replaces": REPLACES[fam][0],
            "also_replaces": "spmv_loop " + REPLACES[fam][1]
                             + ", pallas_call " + REPLACES[fam][2],
            "launches": launches[fam], "headline_variant": head,
            "max_abs_err": variants[head]["max_abs_err"],
            "ms": bench_a["ms"],
            "plain_ms": time_ms(lambda: sv.plain(fam, M, x, head)),
            "bound_ms": bench_a["bound_ms"], "bound_by": bench_a["bound_by"],
            "library_ms": library["bench", "A"], "variants": variants})
    phase(7, "launches on the study path: " + ", ".join(
        f"{k}={v}" for k, v in launches.items()))
    check(not failed, f"phase 7: outside tolerance: {failed}")
    return records


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

    built = build_kernels()
    lib, secs, _ = built[spmv_mod.SOURCE]
    phase(2, f"built {os.path.relpath(lib, HERE)} in {secs:.2f} s")

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

    prob6 = random_lp(262144, 524288, 40, seed=4)
    res6, kkt6, l32b = run_solve(
        6, prob6, Parameters(stop_tol=1e-4, verbose=False, max_iter=50_000),
        card)
    check(kkt6 < 1e-3, f"phase 6: host f64 KKT {kkt6}")

    variant_records = variants_phase(card, built, prob6)

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
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "library_ms": a["library_ms"],
            "ms_AT": at["ms"], "plain_ms_AT": at["plain_ms"],
            "bound_ms_AT": at["bound_ms"], "library_ms_AT": at["library_ms"]})
    kernels += variant_records
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
