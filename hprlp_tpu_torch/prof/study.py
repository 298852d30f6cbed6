"""The variant-study path that prof_*.py share: lay the LP out and scale it
on the card, hold every variant of one kernel family against its plain
version (and the exact ones against A @ x), then time each on A and A^T.

Sizes: "bench" is bench.py's LP (make_problem: 65536 x 131072, 1.31M nnz;
one SpMV reads ~11.5 MB, inside the 50 MB L2); "huge" is
random_lp(262144, 524288, 40, seed=4) (10.5M nnz, ~88 MB per SpMV, from
HBM).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.device_problem import build_device_problem
from ..ops.spmv import spmv_reference, threads_per_row
from ..ops.spmv_variants import WRAPPERS, plain, segsum_rtiles, variant
from ..solver.scaling import scale_problem
from .problems import make_problem, random_lp
from .timing import card, spmv_bound, spmv_bytes, time_ms

SIZES = {"bench": make_problem,
         "huge": lambda: random_lp(262144, 524288, 40, seed=4)}


def device_matrices(problem, device="cuda") -> dict:
    """A and A^T of the scaled f32 LP on `device`, as the solver sees them
    (the port's build_device_problem + scale_problem)."""
    lp, _ = build_device_problem(problem, dtype=torch.float32, device=device)
    scaled, _ = scale_problem(lp)
    return {"A": scaled.A, "AT": scaled.AT}


def study_x(M, seed: int = 0) -> torch.Tensor:
    """The seeded input vector of a study on M."""
    x = np.random.default_rng(seed).normal(size=M.ncols)
    return torch.as_tensor(x, dtype=torch.float32, device=M.device)


def _call(family, M, x, name):
    """The kernel call a study times: mm_precomp gets its R tiles built
    once, outside the call."""
    if family == "segsum" and name == "mm_precomp":
        rtiles = segsum_rtiles(M)
        return lambda: WRAPPERS[family](M, x, name, rtiles=rtiles)
    return lambda: WRAPPERS[family](M, x, name)


def measure(family: str, mats: dict, variants) -> list:
    """Time every variant on every matrix (name -> CUDA CsrMatrix) by
    CUDA-graph replay.  One record per (matrix, variant)."""
    records = []
    for mat, M in mats.items():
        x = study_x(M)
        bound_ms, bound_by = spmv_bound(M, torch.float32)
        nbytes = spmv_bytes(M, torch.float32)
        for name in variants:
            ms = time_ms(_call(family, M, x, name))
            records.append({
                "family": family, "matrix": mat, "variant": name,
                "kind": variant(family, name).kind, "ms": ms,
                "gbps": nbytes / (ms * 1e-3) / 1e9, "bound_ms": bound_ms,
                "bound_by": bound_by, "share": bound_ms / ms})
    return records


def check(family: str, mats: dict, variants) -> list:
    """Every variant against its plain version on the same card, and the
    exact ones against spmv_reference (A @ x), at the variant's tolerance
    times max|y|.  One record per (matrix, variant)."""
    records = []
    for mat, M in mats.items():
        x = study_x(M)
        y_ref = spmv_reference(M, x)
        for name in variants:
            v = variant(family, name)
            y = _call(family, M, x, name)()
            y_plain = plain(family, M, x, name)
            scale = float(y_plain.abs().max())
            rec = {"family": family, "matrix": mat, "variant": name,
                   "kind": v.kind, "tol": v.tol, "scale": scale,
                   "err": float((y - y_plain).abs().max()), "err_ref": None}
            rec["ok"] = rec["err"] <= v.tol * scale
            if v.exact:
                rec["err_ref"] = float((y - y_ref).abs().max())
                rec["ok"] = rec["ok"] and rec["err_ref"] <= v.tol * scale
            records.append(rec)
    return records


def report(timings: list, checks: list, card_name: str, size: str) -> list:
    """One printable line per (matrix, variant)."""
    errs = {(c["matrix"], c["variant"]): c for c in checks}
    lines = []
    for r in timings:
        c = errs[r["matrix"], r["variant"]]
        vs_ref = ("" if c["err_ref"] is None
                  else f"; vs A@x {c['err_ref']:.3e}")
        lines.append(
            f"{r['family']} {size} {r['matrix']:2s} {r['variant']:10s} "
            f"{r['ms'] * 1e3:9.3f} us/SpMV {r['gbps']:8.1f} GB/s "
            f"{r['share']:7.1%} of bound ({r['bound_ms'] * 1e3:.3f} us, "
            f"{r['bound_by']}) {r['kind']} max_abs_err={c['err']:.3e} "
            f"(<= {c['tol']:g}*{c['scale']:.3e}{vs_ref}) [{card_name}]")
    return lines


def main(family: str, variants, argv=None) -> int:
    """The command line of prof_*.py: `--size bench|huge`."""
    parser = argparse.ArgumentParser(
        description=f"Time the {family} SpMV variants on the card.")
    parser.add_argument("--size", choices=sorted(SIZES), default="bench")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the variant studies need a CUDA device")
    card_name = card()
    mats = device_matrices(SIZES[args.size]())
    for mat, M in mats.items():
        bound_ms, bound_by = spmv_bound(M, torch.float32)
        print(f"--- {family} {args.size} {mat}: {M.nrows}x{M.ncols}, "
              f"{M.nnz} nnz, {threads_per_row(M.nnz, M.nrows)} threads/row, "
              f"{spmv_bytes(M, torch.float32) / 1e6:.2f} MB, bound "
              f"{bound_ms * 1e3:.3f} us ({bound_by}) [{card_name}]",
              flush=True)
    checks = check(family, mats, variants)
    for line in report(measure(family, mats, variants), checks,
                       card_name, args.size):
        print(line, flush=True)
    bad = [f"{c['matrix']}/{c['variant']}" for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"{family}: outside tolerance: {bad}")
    return 0

