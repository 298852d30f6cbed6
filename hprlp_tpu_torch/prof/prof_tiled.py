"""Design study of the main-path SpMV (csrc/spmv_tiled.cu on the tiles of
ops/tiles.py): the kernel's stages and a sweep of the number of strip
groups, beside the CSR kernel it succeeded, cuSPARSE and the bound.

    python -m hprlp_tpu_torch.prof.prof_tiled [--size bench|huge]

For A and A^T of the LP (chip_smoke.py phase 3's: bench is
random_lp(65536, 131072, 20, seed=2), huge random_lp(262144, 524288, 40,
seed=4)), in f32 and f64, prints one line per strip-group count G (the
default choice, then 1, 2, 4, 8): the tiles' shape and the us per SpMV of
each stage (every stage at the default G, the main stage otherwise), each
held against the plain version first; then the CSR kernel, torch.mv on a
sparse CSR tensor (cuSPARSE), the bound, and a streaming yardstick
(torch.sum over the tile values), all with the card's name and power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.device_problem import build_device_problem
from ..ops.spmv import MAIN_STAGE, TILED_STAGES, csr_spmv, tiled_spmv
from ..ops.tiles import build_tiles, tiled_spmv_reference
from .problems import random_lp
from .timing import card, spmv_bound, time_ms

SIZES = {"bench": lambda: random_lp(65536, 131072, 20, seed=2),
         "huge": lambda: random_lp(262144, 524288, 40, seed=4)}
GROUPS = (None, 1, 2, 4, 8)
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def sweep(M, x, groups=GROUPS) -> list[str]:
    """One line per strip-group count: tiles and us per SpMV by stage."""
    lines = []
    for G in groups:
        T = build_tiles(M, strip_groups=G)
        y_ref = tiled_spmv_reference(T, x)
        scale = max(1.0, float(y_ref.abs().max()))
        stages = TILED_STAGES if G is None else (MAIN_STAGE,)
        times = []
        for stage in stages:
            y = tiled_spmv(T, x, stage)
            err = float((y - y_ref).abs().max())
            if err > TOL[x.dtype] * scale:
                raise AssertionError(f"G={G} {stage}: max abs err {err}")
            us = time_ms(lambda st=stage: tiled_spmv(T, x, st)) * 1e3
            times.append(f"{stage}={us:.3f}")
        label = f"G={T.n_groups}" + (" (default)" if G is None else "")
        lines.append(f"{label:14s} chunks={T.n_chunks} strips={T.n_strips}x"
                     f"{T.strip_width} per block={T.group_strips} rows<="
                     f"{T.max_block_rows} smem={T.smem_bytes} B: "
                     + " ".join(times) + " us")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", choices=sorted(SIZES), default="huge")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_tiled: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    problem = SIZES[args.size]()
    for dtype in (torch.float32, torch.float64):
        lp, _ = build_device_problem(problem, dtype=dtype, device="cuda")
        for mat, M in (("A", lp.A), ("AT", lp.AT)):
            x = torch.as_tensor(np.random.default_rng(0).normal(
                size=M.ncols), device="cuda").to(dtype)
            head = f"{args.size} {str(dtype)[6:]} {mat} ({M.nnz} nnz)"
            for line in sweep(M, x):
                print(f"{head} {line} [{name}]", flush=True)
            S = torch.sparse_csr_tensor(M.indptr, M.indices, M.vals,
                                        (M.nrows, M.ncols))
            vals = build_tiles(M).vals
            bound, by = spmv_bound(M, dtype)
            print(f"{head} csr={time_ms(lambda: csr_spmv(M, x)) * 1e3:.3f} "
                  f"cusparse={time_ms(lambda: torch.mv(S, x)) * 1e3:.3f} "
                  f"bound={bound * 1e3:.3f} ({by}) sum(tile values)="
                  f"{time_ms(lambda: vals.sum()) * 1e3:.3f} us for "
                  f"{vals.numel() * vals.element_size()} B [{name}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
