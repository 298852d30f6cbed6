"""Time the column-sharded mesh's epilogue (ops/spmv.py::tiled_half_epilogue,
csrc/spmv_tiled.cu half_epilogue_kernel) at the row counts a mesh runs it
at: sparse_large's and sparse_huge's m (the y-half) and n (the x-half), f32
and f64, on seeded operands with infinite bounds.

Each cell prints one JSON line: the time with the inputs out of L2 (each
call takes the next of enough copies to fill the L2 four times, as a mesh
solve meets them after its SpMV) and in L2, by CUDA-graph replay; the
bound (prof/timing.py::epilogue_bound); ulps against the plain update
(solver/chunk.py::x_update / y_update); and, where the package has them,
the launch's plan, the instance's registers and the floor of an empty
kernel on the same grid.  The card's name and power limit come first.

    python -m hprlp_tpu_torch.prof.prof_epilogue [--out FILE]
    python hprlp_tpu_torch/prof/prof_epilogue.py --root OTHER_CHECKOUT

`--root` times another checkout's package (say the parent commit's,
unpacked with git archive) with this script, so two versions can be run in
turns in one call on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import types

CELLS = {"sparse_large": {"y": 65536, "x": 131072},
         "sparse_huge": {"y": 262144, "x": 524288}}


def operands(half, n, dtype, device, seed=3):
    """The summed product and the half's rows (x, last_x, c, l, u or y,
    last_y, AL, AU), a third of the lower and a fifth of the upper bounds
    infinite, and its scalar."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def vec(scale=1.0):
        return torch.as_tensor(rng.normal(size=n) * scale,
                               device=device).to(dtype)

    s, cur, last, c = vec(3.0), vec(), vec(), vec()
    lo = vec()
    hi = lo + torch.abs(vec())
    lo[::3], hi[::5] = -float("inf"), float("inf")
    rows = (cur, last, c, lo, hi) if half == "x" else (cur, last, lo, hi)
    scal = torch.tensor(0.73 if half == "x" else 2.9, dtype=dtype,
                        device=device)
    return s, rows, scal


def run_cell(size, half, dtype):
    import torch

    from hprlp_tpu_torch.ops import spmv as spmv_mod
    from hprlp_tpu_torch.prof.timing import (epilogue_bound, l2_rotations,
                                             time_ms)
    from hprlp_tpu_torch.solver import chunk

    dev = torch.device("cuda")
    n = CELLS[size][half]
    s, rows, scal = operands(half, n, dtype, dev)
    inner = torch.tensor(5, dtype=torch.int32, device=dev)

    def kernel(s_, r_):
        return spmv_mod.tiled_half_epilogue(half, s_, r_, scal, inner, 0)

    def plain(s_, r_):
        f = chunk.Halpern(inner, 0, dtype).factors
        ns = types.SimpleNamespace
        if half == "x":
            return chunk.x_update(ns(c=r_[2], l=r_[3], u=r_[4]), r_[0], s_,
                                  r_[1], scal, *f)[:2]
        return chunk.y_update(ns(AL=r_[2], AU=r_[3]), r_[0], s_, r_[1],
                              scal, *f)[:1]

    got = kernel(s, rows)
    got = got if half == "x" else (got,)
    want = plain(s, rows)
    torch.cuda.synchronize()
    itype = torch.int32 if dtype == torch.float32 else torch.int64
    ulps = max(int((a.view(itype).long() - b.view(itype).long()).abs().max())
               for a, b in zip(got, want))
    k = l2_rotations((1 + len(rows)) * n * s.element_size())
    copies = [tuple(a.clone() for a in (s, *rows)) for _ in range(k)]
    turn = itertools.cycle(copies)

    def cold():
        s1, *r1 = next(turn)
        return kernel(s1, r1)

    bound_ms, bound_by = epilogue_bound(n, dtype, half)
    rec = {"cell": size, "half": half, "rows": n,
           "dtype": str(dtype).split(".")[-1], "ulps": ulps,
           "ms": time_ms(cold, reps=max(50, k)),
           "l2_resident_ms": time_ms(lambda: kernel(s, rows)),
           "bound_ms": bound_ms, "bound_by": bound_by, "rotated_copies": k}
    if hasattr(spmv_mod, "epilogue_launch_plan"):
        P = spmv_mod.epilogue_launch_plan(half, s)
        rec["plan"] = dataclasses.asdict(P)
        rec.update(spmv_mod.epilogue_kernel_info(dev, dtype, half))
        rec["floor_ms"] = time_ms(lambda: spmv_mod.empty_launch(
            dev, P.grid, P.threads))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="time the package of this checkout")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--tag", default="", help="a label for every line")
    a = ap.parse_args(argv)
    if a.root:
        sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from hprlp_tpu_torch.prof.timing import card

    if not torch.cuda.is_available():
        print("prof_epilogue: no CUDA device", file=sys.stderr)
        return 1
    import hprlp_tpu_torch

    where = os.path.dirname(os.path.dirname(os.path.abspath(
        hprlp_tpu_torch.__file__)))
    print(card(), flush=True)
    lines = []
    for size in CELLS:
        for dtype in (torch.float32, torch.float64):
            for half in ("x", "y"):
                rec = {"tag": a.tag, "package": where,
                       **run_cell(size, half, dtype)}
                lines.append(json.dumps(rec))
                print(lines[-1], flush=True)
    if a.out:
        with open(a.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    bad = [r for r in map(json.loads, lines) if r["ulps"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
