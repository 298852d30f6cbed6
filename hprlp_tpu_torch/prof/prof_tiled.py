"""Design study of the main-path SpMV (csrc/spmv_tiled.cu on the tiles of
ops/tiles.py): the kernel's stages and a sweep of the number of strip
groups, for the product and the fused half of each matrix, beside the CSR
kernel it succeeded, cuSPARSE and the bound.

    python -m hprlp_tpu_torch.prof.prof_tiled [--size bench|huge]

For A and A^T of the LP (chip_smoke.py phase 3's: bench is
random_lp(65536, 131072, 20, seed=2), huge random_lp(262144, 524288, 40,
seed=4)), in f32 and f64, prints one line per strip-group count G (the
default choice, then 1 .. 8), each tiling built with the card's resident
clusters (ops/spmv.py::cluster_slots) as a solve builds it: the tiles'
shape (G x chunks, the chunks with rows, the clusters of G resident at
once) and the us per SpMV of each stage (every stage at the default G,
the main stage and block_x otherwise), then the matrix's fused half (the
y-half on A, the x-half on A^T) on the main stage and on block_x (the
previous design: partials through HBM and a group-sum pass), each held
against the plain version first and the main stage bitwise against
block_x; then the CSR kernel, torch.mv on a sparse CSR tensor
(cuSPARSE), the bound, and a streaming yardstick (torch.sum over the
tile values), all with the card's name and power limit.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.device_problem import attach_blocks, build_device_problem
from ..ops.spmv import (MAIN_STAGE, TILED_STAGES, cluster_slots, csr_spmv,
                        max_active_clusters, tiled_spmv, tiled_x_half,
                        tiled_y_half)
from ..ops.tiles import MAX_GROUPS, build_tiles, tiled_spmv_reference
from .problems import random_lp
from .timing import card, half_bound, spmv_bound, time_ms

SIZES = {"bench": lambda: random_lp(65536, 131072, 20, seed=2),
         "huge": lambda: random_lp(262144, 524288, 40, seed=4)}
GROUPS = (None, *range(1, MAX_GROUPS + 1))
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# The stages a sweep line times besides the default G's every stage.
SWEPT = (MAIN_STAGE, "block_x")


def half_call(T, half: str, seed: int = 4):
    """fn(stage) running the fused `half` on T (the x-half on A^T's tiles,
    the y-half on A's) at operands drawn from `seed`, returning its
    outputs."""
    rng = np.random.default_rng(seed)
    dev, dtype = T.vals.device, T.vals.dtype

    def vec(n):
        return torch.as_tensor(rng.normal(size=n), device=dev).to(dtype)

    n = T.nrows
    v, cur, last, p0, lo = vec(T.ncols), vec(n), vec(n), vec(n), vec(n)
    scal = torch.tensor(0.73, dtype=dtype, device=dev)
    inner = torch.tensor(5, dtype=torch.int32, device=dev)
    if half == "x":
        hi = lo + vec(n).abs()
        return lambda stage: tiled_x_half(T, v, cur, last, p0, lo, hi, scal,
                                          inner, 3, stage=stage)
    return lambda stage: (tiled_y_half(T, v, cur, last, lo - 1.0, lo + 1.0,
                                       scal, inner, 3, stage=stage),)


def sweep(M, x, half: str, groups=GROUPS) -> list[str]:
    """One line per strip-group count: tiles, us per SpMV by stage and us
    per fused `half` on the main stage and block_x."""
    lines = []
    for G in groups:
        T = build_tiles(M, strip_groups=G)
        y_ref = tiled_spmv_reference(T, x)
        scale = max(1.0, float(y_ref.abs().max()))
        stages = TILED_STAGES if G is None else SWEPT
        times = []
        for stage in stages:
            y = tiled_spmv(T, x, stage)
            err = float((y - y_ref).abs().max())
            if err > TOL[x.dtype] * scale:
                raise AssertionError(f"G={G} {stage}: max abs err {err}")
            us = time_ms(lambda st=stage: tiled_spmv(T, x, st)) * 1e3
            times.append(f"{stage}={us:.3f}")
        if not torch.equal(tiled_spmv(T, x), tiled_spmv(T, x, "block_x")):
            raise AssertionError(f"G={G}: {MAIN_STAGE} differs from block_x")
        run = half_call(T, half)
        if not all(torch.equal(a, b) for a, b in zip(run(MAIN_STAGE),
                                                     run("block_x"))):
            raise AssertionError(f"G={G}: the {half}-half on {MAIN_STAGE} "
                                 f"differs from block_x")
        for stage in SWEPT:
            us = time_ms(lambda st=stage: run(st)) * 1e3
            times.append(f"{half}_half_{stage}={us:.3f}")
        label = f"G={T.n_groups}" + (" (default)" if G is None else "")
        lines.append(f"{label:14s} chunks={T.n_chunks} live="
                     f"{T.live_chunks} resident={max_active_clusters(T)} "
                     f"strips={T.n_strips}x{T.strip_width} per block="
                     f"{T.group_strips} rows<={T.max_block_rows} smem="
                     f"{T.smem_bytes} B: " + " ".join(times) + " us")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", choices=sorted(SIZES), default="huge")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_tiled: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    print(f"resident clusters of G blocks: {cluster_slots('cuda')} "
          f"[{name}]", flush=True)
    problem = SIZES[args.size]()
    for dtype in (torch.float32, torch.float64):
        lp, _ = build_device_problem(problem, dtype=dtype, device="cuda")
        lp = attach_blocks(lp)
        for mat, M, half in (("A", lp.A, "y"), ("AT", lp.AT, "x")):
            x = torch.as_tensor(np.random.default_rng(0).normal(
                size=M.ncols), device="cuda").to(dtype)
            head = f"{args.size} {str(dtype)[6:]} {mat} ({M.nnz} nnz)"
            for line in sweep(M, x, half):
                print(f"{head} {line} [{name}]", flush=True)
            S = torch.sparse_csr_tensor(M.indptr, M.indices, M.vals,
                                        (M.nrows, M.ncols))
            vals = build_tiles(M).vals
            bound, by = spmv_bound(M, dtype)
            hb, hby = half_bound(M, dtype, 1, half)
            print(f"{head} csr={time_ms(lambda: csr_spmv(M, x)) * 1e3:.3f} "
                  f"cusparse={time_ms(lambda: torch.mv(S, x)) * 1e3:.3f} "
                  f"bound={bound * 1e3:.3f} ({by}) {half}-half bound="
                  f"{hb * 1e3:.3f} ({hby}) sum(tile values)="
                  f"{time_ms(lambda: vals.sum()) * 1e3:.3f} us for "
                  f"{vals.numel() * vals.element_size()} B [{name}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
