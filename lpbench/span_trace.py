"""The program's spans beside the device's trace, for one cell.

    python3 -m lpbench.span_trace --workload <cell> --seed <n> [--rounds 2]

Makes the cell's pool from the seed as run.py does and warms up with one
call; then each round makes three calls on fresh copies of the pool's
instances: one with the spans off, one inside spans.collect(), and one
inside spans.collect() under torch.profiler, where each program span also
lands in the trace as a user annotation ("hprlp::<name>") on the clock of
the kernels and copies.  A JSON line per call: its wall on the host's
clock; for a collected call the seconds by span name and unspanned_s (the
root's seconds that no child covers); for the profiled one also busy_s,
window_s and idle_spans, the device's idle seconds inside the call by the
innermost program span that holds them ("no span" outside the root).
Last, one line with the cost of a span on the host, off and collected,
over SPAN_REPS spans.  The benchmark's runs do not run it.  Needs a CUDA
device unless a test passes device="cpu".
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from lpbench import catalog, span_tree, trace
from lpbench.run import card, seeded

PREFIX = "hprlp::"
NO_SPAN = "no span"
SPAN_REPS = 100_000


def idle_spans(events: list) -> dict:
    """The device's idle seconds inside the call's mark (trace.MARK) of a
    chrome trace, by the innermost program span (a user annotation named
    PREFIX + name) that holds them, the most first; a gap that crosses a
    span's edge is split there."""
    mark = next(e for e in events if e.get("name") == trace.MARK
                and e.get("ph") == "X"
                and e.get("cat") != "gpu_user_annotation")
    w0, w1 = mark["ts"], mark["ts"] + mark["dur"]
    busy = trace._union(
        (max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in events
        if e.get("cat") in trace.DEVICE_CATS and e.get("ph") == "X"
        and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X" and e.get("name", "").startswith(PREFIX)]
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    idle = collections.Counter()
    for g0, g1 in gaps:
        pts = ([g0] + cuts[bisect.bisect_right(cuts, g0):
                            bisect.bisect_left(cuts, g1)] + [g1])
        for a, b in zip(pts, pts[1:]):
            holders = [sp for sp in spans if sp[0] <= a and sp[1] >= b]
            name = (max(holders, key=lambda sp: (sp[0], -sp[1]))[2]
                    if holders else NO_SPAN)
            idle[name] += (b - a) / 1e6
    return dict(idle.most_common())


def _profiled(fn, cuda: bool):
    """(fn()'s result, the chrome trace's events) of one call under the
    profiler, inside trace.MARK."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(trace.MARK):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return out, json.load(f)["traceEvents"]


def calls(cell, seed: int, rounds: int, device=None, out=sys.stdout):
    """The module docstring's calls; returns their rows."""
    from hprlp_tpu_torch import spans

    entry, traffic = cell.entry, cell.traffic
    params = traffic["parameters"]
    cuda = device is None
    pool = entry.make_pool(cell.generator, cell.config, traffic,
                           seeded(seed, "cuda" if cuda else "cpu"))
    entry.call(entry.fresh(pool[0]), params, device)  # warm-up
    rows, k = [], 0
    for r in range(rounds):
        modes = ("off", "collect") if r % 2 == 0 else ("collect", "off")
        for mode in modes + ("profile",):
            k += 1
            args = entry.fresh(pool[k % len(pool)])

            def call():
                return entry.call(args, params, device)

            row = {"round": r, "mode": mode, "instance": k % len(pool)}
            with (spans.collect() if mode != "off"
                  else contextlib.nullcontext()) as records:
                t0 = time.perf_counter()
                if mode == "profile":
                    res, events = _profiled(call, cuda)
                else:
                    res = call()
                row["wall_s"] = time.perf_counter() - t0
            row["status"] = dict(collections.Counter(
                entry.record(res)["status"]))
            del res
            if mode != "off":
                row.update(span_tree.summary(records))
            if mode == "profile":
                mark = next(e for e in events if e.get("name") == trace.MARK
                            and e.get("cat") == "user_annotation")
                red = trace.reduce(events, [], time.perf_counter())
                idle = idle_spans(events)
                total = sum(idle.values())
                root = records[-1].name
                row.update(
                    window_s=mark["dur"] / 1e6, busy_s=red["busy_s"],
                    idle_spans=idle,
                    idle_in_children=(total - idle.get(root, 0.0)
                                      - idle.get(NO_SPAN, 0.0))
                    / total if total else None)
                del events
            print(json.dumps(row), file=out, flush=True)
            rows.append(row)
    return rows


def span_cost(reps: int = SPAN_REPS) -> dict:
    """Microseconds a span costs on the host, inside a root: off, and
    inside spans.collect(); beside them, two clock reads."""
    from hprlp_tpu_torch import spans

    def each(fn):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    def one():
        with spans.span("x"):
            pass

    def clocks():
        time.perf_counter()
        time.perf_counter()

    with spans.span("root"):
        off = each(one)
        with spans.collect():
            on = each(one)
    return {"span_off_us": off, "span_collected_us": on,
            "two_clock_reads_us": each(clocks), "reps": reps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    cell = catalog.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    print(json.dumps({"card": card(), "torch": torch.__version__}),
          flush=True)
    calls(cell, args.seed, args.rounds)
    print(json.dumps(span_cost()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
