"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels and the host library from the checkout's sources,
holds each kernel against its plain PyTorch version at its path's shapes,
drives the main path (hprlp_tpu_torch.solve) on three LPs, the SpMV
variant studies, then the CLI on an MPS file with presolve:

  1. toolchain   nvidia-smi name/power limit, torch, CUDA, nvcc, Triton
  2. build       the three kernel libraries (nvcc, sm_90a, one process per
                 source, started together) and the host library (g++,
                 native/src), with their build times
  3. kernel      the tiled SpMV (main path) and the CSR kernel (previous
                 design), f32 and f64, on A and A^T of random_lp(65536,
                 131072, 20, seed=2) and random_lp(262144, 524288, 40,
                 seed=4): each against its plain version, the tiled one
                 also for bitwise-identical repeats; timings of both, of
                 the tiled kernel's stages and of torch.mv on a sparse CSR
                 tensor (cuSPARSE, the library yardstick), the bound, and
                 the tiles' build time
  4. main f32    solve of the first LP at stop_tol=1e-4 (auto -> f32)
  5. main f64    assignment_problem(64) at 1e-8 (auto -> f64), objective
                 against scipy's linear_sum_assignment
  6. real size   solve of the second LP (10.5M nnz) at 1e-4
  7. variants    the four prof_* studies (hprlp_tpu_torch/prof/) on the
                 bench LP (A, A^T) and on phase 6's LP (A), every variant
                 against its plain version and the exact ones against A @ x
  8. mps + presolve   structured_lp(scale=1.0, seed=7) (950,000 x
                 1,000,000, 10.50M nnz) written as MPS to a temporary
                 directory and solved by hprlp_tpu_torch.cli.main at 1e-4:
                 native reader, native presolve (status OK, the reduced
                 size beside benchmarks/report_presolve_scale.json's),
                 solve on the card (the tiled kernel launched, the CSR
                 kernel never), postsolve, original-space KKT, solution
                 file; that file's x/y/z re-measured in host f64 (KKT <
                 1e-3) and its objective against an in-process solve with
                 presolve off (1e-3 relative); stage times; then
                 `python -m hprlp_tpu_torch.cli -i data/model.mps` in a
                 subprocess

Any failure raises (exit code != 0).  The line before the last is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
Needs torch, numpy and scipy only; imports neither JAX nor hprlp_tpu.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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


def kernel_check(card, problems):
    """Phase 3 on A and A^T of each problem, in f32 and f64.  Returns
    {(size, dtype tag, matrix): record}."""
    from hprlp_tpu_torch.ops.device_problem import build_device_problem
    from hprlp_tpu_torch.ops.spmv import (MAIN_STAGE, TILED_STAGES,
                                          csr_spmv, max_active_clusters,
                                          spmv_reference, tiled_spmv)
    from hprlp_tpu_torch.ops.tiles import build_tiles, tiled_spmv_reference

    rng = np.random.default_rng(0)
    records = {}
    for size, problem in problems.items():
        for dtype, rtol, tag in ((torch.float32, 1e-5, "f32"),
                                 (torch.float64, 1e-12, "f64")):
            lp, _ = build_device_problem(problem, dtype=dtype, device="cuda")
            for mat_name, M in (("A", lp.A), ("AT", lp.AT)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                T = build_tiles(M)
                torch.cuda.synchronize()
                tiles_s = time.perf_counter() - t0
                x = torch.as_tensor(rng.normal(size=M.ncols), device="cuda"
                                    ).to(dtype)
                y = tiled_spmv(T, x)
                y_again = tiled_spmv(T, x)
                y_ref = tiled_spmv_reference(T, x)
                y_csr = csr_spmv(M, x)
                y_csr_ref = spmv_reference(M, x)
                torch.cuda.synchronize()
                scale = float(y_ref.abs().max())
                err = float((y - y_ref).abs().max())
                err_csr = float((y_csr - y_csr_ref).abs().max())
                what = f"{size} {tag} {mat_name}"
                check(err <= rtol * scale, f"{what}: tiled max abs err "
                      f"{err} > {rtol} * {scale}")
                check(torch.equal(y, y_again),
                      f"{what}: two tiled launches differ")
                check(err_csr <= rtol * scale, f"{what}: CSR max abs err "
                      f"{err_csr} > {rtol} * {scale}")
                # The stages: each x path on the main tiles, and x staged
                # per block on tiles of one strip group (row blocks only).
                one_group = build_tiles(M, strip_groups=1)
                runs = [(stage, T, stage) for stage in TILED_STAGES]
                runs.append(("block_x_one_group", one_group, "block_x"))
                stages = {}
                for name, tiles, stage in runs:
                    y_s = tiled_spmv(tiles, x, stage)
                    torch.cuda.synchronize()
                    e = float((y_s - y_ref).abs().max())
                    check(e <= rtol * scale, f"{what}: stage {name} max "
                          f"abs err {e}")
                    stages[name] = time_ms(
                        lambda t=tiles, st=stage: tiled_spmv(t, x, st))
                bound_ms, bound_by = spmv_bound(M, dtype)
                rec = {
                    "err": err, "scale": scale, "err_csr": err_csr,
                    "nnz": M.nnz, "tiles_s": tiles_s,
                    "strips": T.n_strips, "strip_width": T.strip_width,
                    "groups": T.n_groups, "chunks": T.n_chunks,
                    "blocks": T.n_blocks, "smem": T.smem_bytes,
                    "clusters8": max_active_clusters(T, "cluster8_x"),
                    "ms": stages[MAIN_STAGE],
                    "plain_ms": time_ms(lambda: tiled_spmv_reference(T, x)),
                    "csr_ms": time_ms(lambda: csr_spmv(M, x)),
                    "csr_plain_ms": time_ms(lambda: spmv_reference(M, x)),
                    "library_ms": time_ms(library_call(M, x)),
                    "eager_ms": eager_ms(lambda: tiled_spmv(T, x)),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "stages": stages}
                records[size, tag, mat_name] = rec
                phase(3, f"{what} ({M.nnz} nnz): tiles of {T.n_strips} "
                         f"strips of {T.strip_width} in {T.n_groups} groups x "
                         f"{T.n_chunks} row chunks, {T.smem_bytes} B shared, "
                         f"built in {tiles_s:.3f} s; "
                         f"max_abs_err={err:.3e} (<= {rtol:g}*{scale:.3e}), "
                         f"repeat bitwise-identical; tiled={rec['ms']:.5f} ms "
                         f"({rec['bound_ms'] / rec['ms']:.1%} of bound "
                         f"{bound_ms:.5f} ms, {bound_by}) plain="
                         f"{rec['plain_ms']:.5f} csr={rec['csr_ms']:.5f} "
                         f"(err {err_csr:.3e}) csr_plain="
                         f"{rec['csr_plain_ms']:.5f} library="
                         f"{rec['library_ms']:.5f} eager_tiled="
                         f"{rec['eager_ms']:.5f} [{card}]")
                phase(3, f"{what} stages (ms, graph replay): " + ", ".join(
                    f"{k}={v:.5f}" for k, v in stages.items())
                    + f"; {rec['clusters8']} clusters of 8 fit at once")
    return records


def run_solve(n, problem, params, card):
    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch.ops.spmv import csr_spmv, tiled_spmv

    csr_spmv.launches = 0
    tiled_spmv.launches = 0
    res = hp.solve(problem.A, problem.AL, problem.AU, problem.l, problem.u,
                   problem.c, params, obj_constant=problem.obj_constant)
    launches = tiled_spmv.launches
    check(csr_spmv.launches == 0, f"phase {n}: the solve launched the CSR "
          f"kernel {csr_spmv.launches} times")
    kkt = problem.kkt_error(res.x, res.y, res.z)["kkt"]
    its = res.iter / res.time if res.time > 0 else float("nan")
    phase(n, f"{problem.name}: status={res.status} iter={res.iter} "
             f"setup={res.setup_time:.3f}s scaling={res.scaling_time:.3f}s "
             f"power={res.power_time:.3f}s solve={res.time:.3f}s "
             f"it/s={its:.1f} launches={launches} "
             f"primal_obj={res.primal_obj:.10e} kkt_f64={kkt:.3e} [{card}]")
    check(launches > 0, f"phase {n}: the tiled kernel was never launched")
    check(res.status == "OPTIMAL", f"phase {n}: status {res.status}")
    return res, kkt, launches


def build_kernels():
    """Build every kernel library at once, one nvcc process per source,
    and the host library (presolve, MPS reader; one g++) beside them.
    Returns {source: (library, seconds, nvcc -Xptxas -v output)}, the host
    library under native.LIB_PATH."""
    from hprlp_tpu_torch import native
    from hprlp_tpu_torch.ops import spmv, spmv_variants

    sources = (spmv.TILED_SOURCE, spmv.SOURCE, spmv_variants.SOURCE)
    logs = {src: [] for src in sources}

    def one(src):
        t0 = time.perf_counter()
        lib = (native.build() if src == native.LIB_PATH
               else spmv.build(src, logs[src]))
        return lib, time.perf_counter() - t0

    jobs = (*sources, native.LIB_PATH)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(one, jobs)))
    return {src: (*built[src], "".join(logs.get(src, []))) for src in jobs}


@contextlib.contextmanager
def recorded(record, calls):
    """Wrap each (owner, attribute) of `calls` so that every call appends
    (attribute, seconds, result) to `record`; restore them on exit."""
    saved = [(owner, name, getattr(owner, name)) for owner, name in calls]

    def wrap(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            record.append((name, time.perf_counter() - t0, out))
            return out
        return timed

    for owner, name, fn in saved:
        setattr(owner, name, wrap(name, fn))
    try:
        yield record
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def read_solution(path):
    """The CLI's solution file (cli.write_solution) as (dict of the
    `key value` lines, {"x": array, "y": array, "z": array})."""
    with open(path) as f:
        lines = f.read().splitlines()
    head, vecs, k = {}, {}, 0
    while k < len(lines):
        key, val = lines[k].split(" ", 1)
        k += 1
        if key in ("x", "y", "z"):
            size = int(val)
            vecs[key] = np.array(lines[k:k + size], dtype=np.float64)
            k += size
        else:
            head[key] = val
    return head, vecs


# Phase 8's LP: structured_lp(MPS_SCALE), 10.50M nnz at 1.0.
MPS_SCALE = 1.0
# benchmarks/report_presolve_scale.json at scale 1.0: the reduced problem.
REPORT_REDUCED = (500_000, 549_999, 8_249_671)


def mps_phase(card, scale, cli_extra=()):
    """Phase 8: structured_lp(scale) written as MPS, solved by
    cli.main (native reader, presolve, tiled-kernel solve, postsolve,
    original-space KKT, solution file), checked against a presolve-off
    solve.  Returns (tiled_spmv launches during cli.main, record)."""
    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch import cli, native, presolve
    from hprlp_tpu_torch.io import native_mps
    from hprlp_tpu_torch.ops.spmv import csr_spmv, tiled_spmv
    from hprlp_tpu_torch.prof.problems import structured_lp, write_mps

    check(native.is_available(), f"phase 8: the host library did not load: "
          f"{native.lib_error}")
    t0 = time.perf_counter()
    problem = structured_lp(scale=scale, seed=7)
    gen_s = time.perf_counter() - t0
    phase(8, f"structured_lp(scale={scale}, seed=7): {problem.m} x "
             f"{problem.n}, {problem.nnz} nnz, generated in {gen_s:.2f} s")
    tmp = tempfile.mkdtemp(prefix="hprlp_smoke_")
    try:
        need = 80 * problem.nnz  # ~52 bytes per written entry, and slack
        free = shutil.disk_usage(tmp).free
        check(free > need, f"phase 8: {free} bytes free in {tmp}, the MPS "
              f"file needs ~{need}")
        mps, sol = os.path.join(tmp, "lp.mps"), os.path.join(tmp, "sol.txt")
        t0 = time.perf_counter()
        write_mps(problem, mps)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(mps)

        record = []
        csr_spmv.launches = 0
        tiled_spmv.launches = 0
        with recorded(record, [(native_mps, "read_mps_native"),
                               (presolve, "presolve_problem"),
                               (presolve.PresolveHandle, "postsolve"),
                               (presolve, "validate_original_kkt"),
                               (hp.Model, "solve")]):
            t0 = time.perf_counter()
            rc = cli.main(["-i", mps, "--tol", "1e-4", "--quiet",
                           "--solution-out", sol, *cli_extra])
            cli_s = time.perf_counter() - t0
        launches, csr_launches = tiled_spmv.launches, csr_spmv.launches
        stage = {name: (secs, out) for name, secs, out in record}
        check(set(stage) == {"read_mps_native", "presolve_problem",
                             "postsolve", "validate_original_kkt", "solve"},
              f"phase 8: the CLI took another path: {sorted(stage)}")
        status, reduced, _ = stage["presolve_problem"][1]
        check(status == "OK", f"phase 8: presolve status {status}")
        res = stage["solve"][1]
        phase(8, f"reduced {reduced.m} x {reduced.n}, {reduced.nnz} nnz "
                 f"(benchmarks/report_presolve_scale.json at scale 1.0: "
                 f"{REPORT_REDUCED[0]} x {REPORT_REDUCED[1]}, "
                 f"{REPORT_REDUCED[2]} nnz)")
        head, vecs = read_solution(sol)
        kkt = problem.kkt_error(vecs["x"], vecs["y"], vecs["z"])
        times = {"write": write_s, "native_read": stage["read_mps_native"][0],
                 "presolve": res.presolve_time, "setup": res.setup_time,
                 "scaling": res.scaling_time, "power": res.power_time,
                 "solve": res.time, "postsolve": stage["postsolve"][0],
                 "kkt_validation": stage["validate_original_kkt"][0],
                 "cli_main": cli_s}
        phase(8, f"cli.main rc={rc} status={head['status']} "
                 f"iter={head['iter']} primal_obj={head['primal_obj']} "
                 f"kkt_f64={kkt['kkt']:.3e} launches={launches} "
                 f"csr_launches={csr_launches}; file {size} bytes; stage "
                 f"times (s): " + ", ".join(f"{k}={v:.3f}"
                                            for k, v in times.items())
              + f" [{card}]")

        t0 = time.perf_counter()
        ref = hp.Model(problem).solve(hp.Parameters(
            stop_tol=1e-4, verbose=False, use_presolve=False),
            device="cpu" if "cpu" in cli_extra else None)
        ref_s = time.perf_counter() - t0
        obj = float(head["primal_obj"])
        rel = abs(obj - ref.primal_obj) / max(1.0, abs(ref.primal_obj))
        phase(8, f"presolve off, in-process: status={ref.status} "
                 f"iter={ref.iter} setup={ref.setup_time:.3f}s "
                 f"scaling={ref.scaling_time:.3f}s power="
                 f"{ref.power_time:.3f}s solve={ref.time:.3f}s "
                 f"(all {ref_s:.3f}s) primal_obj={ref.primal_obj:.10e}; "
                 f"rel diff {rel:.3e} [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "hprlp_tpu_torch.cli", "-i",
         os.path.join(HERE, "data", "model.mps"), "--quiet", *cli_extra],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    phase(8, f"python -m hprlp_tpu_torch.cli -i data/model.mps --quiet: "
             f"rc={proc.returncode} in {time.perf_counter() - t0:.1f} s: "
             f"{proc.stdout.strip()}")

    check(rc == 0 and head["status"] == "OPTIMAL",
          f"phase 8: cli.main rc={rc}, status {head['status']}")
    check(kkt["kkt"] < 1e-3, f"phase 8: host f64 KKT {kkt['kkt']}")
    check(ref.status == "OPTIMAL", f"phase 8: presolve-off status "
          f"{ref.status}")
    check(rel < 1e-3, f"phase 8: objective {obj} against {ref.primal_obj} "
          f"with presolve off")
    check(csr_launches == 0, f"phase 8: cli.main launched the CSR kernel "
          f"{csr_launches} times")
    check(launches > 0, "phase 8: the tiled kernel was never launched")
    check(proc.returncode == 0 and "status=OPTIMAL" in proc.stdout,
          f"phase 8: python -m hprlp_tpu_torch.cli failed: {proc.stdout}"
          f"{proc.stderr[-2000:]}")
    return launches, {
        "m": problem.m, "n": problem.n, "nnz": problem.nnz,
        "reduced": [reduced.m, reduced.n, reduced.nnz], "iter": res.iter,
        "iter_presolve_off": ref.iter, "kkt_f64": kkt["kkt"],
        "times_s": times}


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
    from hprlp_tpu_torch import Parameters, native
    from hprlp_tpu_torch.ops import spmv as spmv_mod

    pkg_dir = os.path.dirname(os.path.abspath(hprlp_tpu_torch.__file__))
    check(os.path.dirname(pkg_dir) == HERE,
          f"hprlp_tpu_torch imported from {pkg_dir}, not this checkout")
    check("jax" not in sys.modules and "hprlp_tpu" not in sys.modules,
          "the port imported JAX")

    card = toolchain()

    built = build_kernels()
    for src in (spmv_mod.TILED_SOURCE, spmv_mod.SOURCE):
        lib, secs, log = built[src]
        phase(2, f"built {os.path.relpath(lib, HERE)} in {secs:.2f} s")
    for line in ptxas_summary(built[spmv_mod.TILED_SOURCE][2]):
        phase(2, f"ptxas {line}")
    lib, secs, _ = built[native.LIB_PATH]
    phase(2, f"built {os.path.relpath(lib, HERE)} (host: presolve, MPS "
             f"reader; g++) in {secs:.2f} s")

    prob4 = random_lp(65536, 131072, 20, seed=2)
    prob6 = random_lp(262144, 524288, 40, seed=4)
    rec = kernel_check(card, {"bench": prob4, "huge": prob6})
    for mat in ("A", "AT"):
        r = rec["huge", "f32", mat]
        check(r["ms"] < r["csr_ms"], f"phase 3: the tiled kernel "
              f"({r['ms']} ms) is not faster than the CSR kernel "
              f"({r['csr_ms']} ms) at sparse_huge {mat} f32")

    res4, kkt4, l32a = run_solve(
        4, prob4,
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
        6, prob6, Parameters(stop_tol=1e-4, verbose=False, max_iter=50_000),
        card)
    check(kkt6 < 1e-3, f"phase 6: host f64 KKT {kkt6}")

    variant_records = variants_phase(card, built, prob6)

    l8, mps_record = mps_phase(card, MPS_SCALE)

    def shapes(tag, keys):
        return {f"{size}_{mat}": {k: rec[size, tag, mat][k] for k in keys}
                for size in ("bench", "huge") for mat in ("A", "AT")}

    kernels = []
    for tag, launches, replaces, also in (
            ("f32", l32a + l32b + l8, "hprlp_tpu/ops/pallas_spmv.py:67",
             "thin_spmv hprlp_tpu/ops/pallas_spmv.py:272"),
            ("f64", l64, "hprlp_tpu/ops/pallas_spmv.py:178",
             "thin_spmv_df64 hprlp_tpu/ops/pallas_spmv.py:394")):
        a = rec["bench", tag, "A"]
        kernels.append({
            "name": f"spmv_tiled_{tag}", "route": "cuda",
            "source": os.path.relpath(spmv_mod.TILED_SOURCE, HERE),
            "replaces": replaces, "also_replaces": also,
            "stage": spmv_mod.MAIN_STAGE, "launches": launches,
            "max_abs_err": max(r["err"] for (_, t, _), r in rec.items()
                               if t == tag),
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "library_ms": a["library_ms"],
            "shapes": shapes(tag, ("nnz", "ms", "plain_ms", "bound_ms",
                                   "library_ms", "csr_ms", "tiles_s",
                                   "stages"))})
    for tag, replaces, also in (
            ("f32", "hprlp_tpu/ops/pallas_spmv.py:67",
             "thin_spmv hprlp_tpu/ops/pallas_spmv.py:272"),
            ("f64", "hprlp_tpu/ops/pallas_spmv.py:178",
             "thin_spmv_df64 hprlp_tpu/ops/pallas_spmv.py:394")):
        a = rec["bench", tag, "A"]
        kernels.append({
            "name": f"csr_spmv_{tag}", "route": "cuda",
            "source": os.path.relpath(spmv_mod.SOURCE, HERE),
            "replaces": replaces, "also_replaces": also,
            "previous_design": "succeeded on the main path by "
                               f"spmv_tiled_{tag}; timed in phase 3 only",
            "launches": 0,
            "max_abs_err": max(r["err_csr"] for (_, t, _), r in rec.items()
                               if t == tag),
            "ms": a["csr_ms"], "plain_ms": a["csr_plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "library_ms": a["library_ms"],
            "shapes": shapes(tag, ("csr_ms", "csr_plain_ms", "bound_ms",
                                   "library_ms"))})
    kernels[0]["launches_by_phase"] = {"4": l32a, "6": l32b, "8": l8}
    kernels[0]["mps_presolve"] = mps_record
    kernels += variant_records
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
