"""The readings that the limits of `correct` are set from, for one cell.

    python3 -m lpbench.control --workload <cell> --seeds 101 102 ...

For each seed: the first LP (or batch) of the pool that a run with that
seed makes, one call through the cell's entry after one warm-up call, and
the reference's float64 KKT error of every answer of the call: the
program's (the sound reading), and the same answer rounded to bfloat16,
the precision below the float32 the cell states (the control: a solver
working in bfloat16 can at best return a rounded point).  A line per seed,
then the largest sound reading and the smallest control reading.  The
benchmark's runs do not run it.  Needs a CUDA device unless a test passes
device="cpu".
"""

from __future__ import annotations

import argparse
import json
import sys

from lpbench import catalog, reference
from lpbench.run import seeded


def readings(cell, seeds, device=None, out=sys.stdout) -> dict:
    """Per seed, the worst KKT error of the call's answers as returned and
    rounded to bfloat16, with the call's statuses and iterations."""
    entry, traffic = cell.entry, cell.traffic
    one = {**traffic, "pool": 1}
    params = traffic["parameters"]
    rows = []
    for i, seed in enumerate(seeds):
        inst = entry.make_pool(cell.generator, cell.config, one,
                               seeded(seed, device or "cuda"))[0]
        if i == 0:
            entry.call(entry.fresh(inst), params, device)  # warm-up
        res = entry.call(entry.fresh(inst), params, device)
        rec = entry.record(res)
        B = entry.shape(inst)["batch"]
        sound = control = ratio = 0.0
        for b in range(B):
            x, y, z, own = ((res.x, res.y, res.z, res.residuals) if B == 1
                            else (res.x[:, b], res.y[:, b], res.z[:, b],
                                  res.residuals[b]))
            args = entry.member(inst, b)
            kkt = reference.kkt(*args, x, y, z)["kkt"]
            sound, ratio = max(sound, kkt), max(ratio, kkt / own)
            control = max(control, reference.kkt(
                *args, *(reference.bfloat16(v) for v in (x, y, z)))["kkt"])
        row = {"seed": seed, "sound": sound, "control": control,
               "over_own": ratio,
               "not_optimal": sum(s != "OPTIMAL" for s in rec["status"]),
               "iters": rec["iters"], "backend": rec["backend"]}
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
    summary = {"lower": max(r["sound"] for r in rows),
               "upper": min(r["control"] for r in rows),
               "limit": cell.limits["kkt_worst"], "seeds": len(rows)}
    print(json.dumps(summary), file=out, flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = catalog.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    readings(cell, args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
