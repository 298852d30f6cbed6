"""`precision="mixed"` stage by stage on sparse_large's LP family
(`random_lp(m, 2m, 20, seed=2)`), with the SpMV backend forced: each
stage's zoom, iterations, host-f64 KKT and backend, and the f64 tail's,
from solver/refine.py's stage lines (HPRLP_REFINE_LOG) and the stages'
Results.

    python -m hprlp_tpu_torch.prof.prof_mixed [--m 65536 32768 ...]
        [--backend lane gather] [--tol 1e-6] [--device cuda|cpu]

prints one JSON line per (m, backend): status, total iterations, the
stages, the host-f64 KKT of the answer and the wall seconds; then, per m,
the ratio of the backends' total iterations.  "lane" is the tiles'
parameter value (Results.spmv_backend "tiled").
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

STAGE = re.compile(r"\[refine\] stage (\d+): zoom=(\S+) stage_iter=(\d+) "
                   r"kkt=(\S+)")
TAIL = re.compile(r"\[refine\] f64 tail \((\w+)\) from kkt=(\S+)")


def staged(solve_refined, loop_mod, problem, params, **kw):
    """solve_refined(problem, params, **kw) with its stage lines captured
    (HPRLP_REFINE_LOG) and each stage's and tail's solve recorded through
    loop_mod.solve_problem, which solve_refined looks up when it runs (the
    port's or the JAX package's modules alike): (Results, stages, tails),
    each stage {stage, zoom, iter, kkt, backend}, each tail {kind,
    from_kkt, iter, status, backend}."""
    solves = []
    inner = loop_mod.solve_problem

    def recorded(*a, **k):
        r = inner(*a, **k)
        solves.append({"iter": int(r.iter), "status": r.status,
                       "backend": r.spmv_backend})
        return r

    err = io.StringIO()
    was = os.environ.get("HPRLP_REFINE_LOG")
    os.environ["HPRLP_REFINE_LOG"] = "1"
    loop_mod.solve_problem = recorded
    try:
        with contextlib.redirect_stderr(err):
            res = solve_refined(problem, params, **kw)
    finally:
        loop_mod.solve_problem = inner
        if was is None:
            del os.environ["HPRLP_REFINE_LOG"]
        else:
            os.environ["HPRLP_REFINE_LOG"] = was
    lines = err.getvalue().splitlines()
    stages = [{"stage": int(g[0]), "zoom": float(g[1]), "iter": int(g[2]),
               "kkt": float(g[3])}
              for g in (STAGE.search(x).groups() for x in lines
                        if STAGE.search(x))]
    for st, sv in zip(stages, solves):
        st["backend"] = sv["backend"]
    tails = [{"kind": g[0], "from_kkt": float(g[1])}
             for g in (TAIL.search(x).groups() for x in lines
                       if TAIL.search(x))]
    for tl, sv in zip(tails, solves[len(stages):]):
        tl.update(iter=sv["iter"], status=sv["status"],
                  backend=sv["backend"])
    return res, stages, tails


def run(m: int, backend: str, tol: float, device: str, max_iter: int):
    import numpy as np

    import hprlp_tpu_torch as ht
    from hprlp_tpu_torch.prof.problems import random_lp
    from hprlp_tpu_torch.solver import loop, refine

    problem = random_lp(m, 2 * m, 20, seed=2)
    params = ht.Parameters(stop_tol=tol, precision="mixed", verbose=False,
                           use_presolve=False, spmv_backend=backend,
                           max_iter=max_iter)
    t = time.perf_counter()
    res, stages, tails = staged(refine.solve_refined, loop, problem, params,
                                device=device)
    wall = time.perf_counter() - t
    kkt = problem.kkt_error(np.asarray(res.x), np.asarray(res.y),
                            np.asarray(res.z))["kkt"]
    return {"m": m, "n": 2 * m, "nnz": int(problem.A.nnz),
            "backend": backend, "tol": tol, "device": device,
            "status": res.status, "iter": int(res.iter),
            "kkt_host_f64": float(kkt), "stages": stages, "tails": tails,
            "wall_s": round(wall, 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[65536])
    ap.add_argument("--backend", nargs="+", default=["lane", "gather"])
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-iter", type=int, default=500_000)
    ap.add_argument("--out", help="also append the JSON lines to this file")
    a = ap.parse_args(argv)
    if a.device.startswith("cuda"):
        import torch

        from hprlp_tpu_torch.prof.timing import card

        if not torch.cuda.is_available():
            print("prof_mixed: no CUDA device", file=sys.stderr)
            return 1
        print(card(), flush=True)
    out = []
    for m in a.m:
        iters = {}
        for backend in a.backend:
            rec = run(m, backend, a.tol, a.device, a.max_iter)
            iters[backend] = rec["iter"]
            out.append(json.dumps(rec))
            print(out[-1], flush=True)
        if len(iters) == 2:
            (b0, i0), (b1, i1) = iters.items()
            out.append(json.dumps({"m": m, "ratio": f"{b0}/{b1}",
                                   "iter_ratio": i0 / max(i1, 1)}))
            print(out[-1], flush=True)
    if a.out:
        with open(a.out, "a") as f:
            f.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
