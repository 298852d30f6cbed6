"""Run one cell of the benchmark once.

    python3 -m lpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of the repository.  A run loads the cell's configuration and
traffic files by name (catalog.py), makes its pool of LPs on the host from
the seed, warms up with one whole call through the traffic's entry, then
measures for --seconds: one caller in a closed loop, each call on fresh
copies of the pool's next instance.  With --trace 1 one more call runs
under torch.profiler.  Once the window has closed the answers are judged
by the plain reference (reference.py), and the last line of standard
output is one JSON object: correct, attempted, failed, metrics, device,
with --trace 1 breakdown, and last the numbers compared with their limits
("checks"), which also end standard error.  Everything else goes to
earlier lines.

It needs a CUDA device and does not fall back to the CPU.  It exits with
another code than 0, and prints no result, without one, when a part is
missing, or when jax, jaxlib, flax or hprlp_tpu is loaded once the window
has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lpbench import catalog, reference, trace  # noqa: E402

# Kernel caches live at fixed paths inside the checkout, so that only a
# checkout's first run builds: the port's nvcc builds in
# hprlp_tpu_torch/_build/ (fixed by the program), Triton's here.
os.environ["TRITON_CACHE_DIR"] = os.path.join(catalog.HERE, ".cache",
                                              "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "hprlp_tpu")


class Run:
    """What one run measured; the metric readers read it."""

    def __init__(self, cell, trace: bool):
        self.cell, self.trace_on, self.traffic = cell, trace, cell.traffic
        self.setup_s = self.pool_s = None
        self.shape = None  # m, n, nnz, batch of the pool's LPs
        self.warmup = None  # the warm-up call's record
        self.calls = []  # the window's calls' records
        self.window_s = 0.0
        self.attempted = self.solved = self.errors = 0
        self.profiled = None  # the profiled call's record
        self.trace = None  # trace.reduce's readings of that call
        self.answers = []
        self.pool = None  # the LPs the answers are judged against


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def card() -> dict | None:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    fields = "name,power.limit,power.draw,clocks.sm,clocks.max.sm," \
        "temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    values = out.stdout.strip().splitlines()[0].split(", ")
    return dict(zip(fields.split(","), values))


def seeded(seed: int, device: str):
    """The torch generator on `device` that a run with `seed` makes its
    LPs from."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    return gen


def _call(run, entry, inst, k, params, device, cuda, profile=False):
    """One call on fresh copies of the pool's instance k: its record and
    result.  The copy is made outside the call's clock."""
    args = entry.fresh(inst)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if profile:
        res, run.trace = trace.profile_call(
            lambda: entry.call(args, params, device), cuda=cuda)
        wall = run.trace["window_s"]
    else:
        t0 = time.perf_counter()
        res = entry.call(args, params, device)
        wall = time.perf_counter() - t0
    rec = entry.record(res)
    rec.update(instance=k, wall_s=wall,
               peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0)
    return rec, res


def execute(cell, seed: int, seconds: float, traced: bool, device=None,
            t_start: float = T_START) -> Run:
    """The run, up to the judging.  device None: the card (cuda:0); the
    CPU only where a test asks for it."""
    cuda = device is None
    run = Run(cell, traced)
    entry, traffic = cell.entry, cell.traffic
    params = traffic["parameters"]
    seed = int(seed) % 2**63
    pool = entry.make_pool(cell.generator, cell.config, traffic,
                           seeded(seed, "cuda" if cuda else "cpu"))
    picks = np.random.default_rng([seed, 1])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    run.shape = entry.shape(pool[0])
    B = run.shape["batch"]

    run.pool_s = time.perf_counter() - t_start
    run.warmup, res = _call(run, entry, pool[0], 0, params, device, cuda)
    del res
    run.setup_s = time.perf_counter() - t_start

    k = 1
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < seconds:
        i = k % len(pool)
        run.attempted += B
        try:
            rec, res = _call(run, entry, pool[i], i, params, device, cuda)
        except Exception:  # a call that fails ends the window, not the run
            traceback.print_exc()
            run.errors += 1
            break
        run.calls.append(rec)
        run.solved += rec["status"].count("OPTIMAL")
        run.answers += entry.keep(res, i, picks, traffic)
        del res
        k += 1
    run.window_s = time.perf_counter() - t_open

    if traced and not run.errors:
        i = k % len(pool)
        try:
            run.profiled, res = _call(run, entry, pool[i], i, params,
                                      device, cuda, profile=True)
            run.answers += entry.keep(res, i, picks, traffic)
            del res
        except Exception:
            traceback.print_exc()
            run.errors += 1

    for rec in [run.warmup, *run.calls] + ([run.profiled]
                                           if run.profiled else []):
        shown = {**rec, "status": dict(collections.Counter(rec["status"]))}
        print(json.dumps({"call": shown, "warmup": rec is run.warmup},
                         default=_plain))
    if cuda:
        torch.cuda.empty_cache()
    run.pool = pool
    return run


def _plain(v):
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def judge(run) -> dict:
    """The numbers compared, each with its limit (limits/<cell>.json): the
    worst float64 KKT error of the judged answers, and the LPs not
    reported OPTIMAL."""
    worst, ratio = 0.0, 0.0
    for a in run.answers:
        args = run.cell.entry.member(run.pool[a["instance"]], a["member"])
        kkt = reference.kkt(*args, a["x"], a["y"], a["z"])["kkt"]
        worst = max(worst, kkt)
        ratio = max(ratio, kkt / a["reported"] if a["reported"] else 0.0)
    print(f"answers judged: {len(run.answers)}; the reference's KKT over "
          f"the program's own, at most {ratio!r}", file=sys.stderr)
    not_optimal = run.attempted - run.solved + sum(
        s != "OPTIMAL" for s in (run.profiled or {}).get("status", []))
    limits = run.cell.limits
    return {"kkt_worst": {"value": worst, "limit": limits["kkt_worst"]},
            "not_optimal": {"value": not_optimal,
                            "limit": limits["not_optimal"]}}


def result(run, checks: dict, device: dict) -> dict:
    """The result line's object."""
    metrics = {}
    for m in (run.cell.per_layer if run.trace_on else run.cell.end_to_end):
        value = catalog.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (run.errors == 0 and len(run.answers) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.attempted - run.solved, "metrics": metrics,
           "device": device}
    if run.trace_on and run.trace:
        out["device"] = {**device, "busy_s": run.trace["busy_s"],
                         "window_s": run.trace["window_s"]}
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    return out


def finish(run, device: dict) -> int:
    """Judge, print the result, and return the exit code."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    checks = judge(run)
    line = result(run, checks, device)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = catalog.find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    info = card()
    print(json.dumps({"card": info, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    run = execute(cell, args.seed, args.seconds, bool(args.trace))
    print(json.dumps({"card_after": card(), "window_s": run.window_s,
                      "calls": len(run.calls), "setup_s": run.setup_s,
                      "pool_s": run.pool_s, "trace": run.trace and {
                          k: run.trace[k] for k in (
                              "window_s", "busy_s", "loop_device_s",
                              "loop_replays")}}),
          flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": max(
                  r["peak_bytes"] for r in
                  [run.warmup, *run.calls, *([run.profiled]
                                             if run.profiled else [])])}
    return finish(run, device)


if __name__ == "__main__":
    sys.exit(main())
