"""One call under torch.profiler, and the reduction of its trace.

The profiler records the device's operations (kernels, copies, fills) and
the host's CUDA runtime calls; a thread samples the calling thread's
Python stack meanwhile, so that an idle stretch of the device is named by
what the host was doing then.  From the trace:

- busy_s: the union of the device's operations inside the call's wall;
  window_s: that wall.
- device_ops: device seconds by operation name, the most first.
- idle_gaps: the device's idle seconds inside the call, by the host's most
  sampled stack in each gap of SAMPLE_S or more; shorter gaps are summed
  under one name.
- The loop's replays: every kernel that a CUDA graph launch ran carries
  that launch's correlation id.  The loop is the graph of the call's last
  launch (its kernels' "graph id" where the trace has one, else its number
  of kernels), and loop_device_s sums the device time of every kernel that
  starts between the first and the last kernel of its replays, whatever
  their names: a kernel fused, renamed or added keeps the reading.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SAMPLE_S = 0.002
MARK = "lpbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160


def _where(frame) -> str:
    """The innermost frame of the program's package, and the innermost
    frame if another: what the host was running."""
    def short(f):
        parts = f.f_code.co_filename.replace(os.sep, "/").split("/")
        return f"{'/'.join(parts[-2:])}:{f.f_code.co_name}"

    inner, program = short(frame), None
    f = frame
    while f is not None:
        if "hprlp_tpu_torch" in f.f_code.co_filename:
            program = short(f)
            break
        f = f.f_back
    if program is None or program == inner:
        return inner
    return f"{program} > {inner}"


class StackSampler:
    """Samples the stack of the thread that enters it every `every`
    seconds: (perf_counter, _where(frame)) in `samples`."""

    def __init__(self, every: float = SAMPLE_S):
        self.every = every
        self.samples: list = []
        self._stop = threading.Event()
        self._tid = threading.get_ident()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.every):
            frame = sys._current_frames().get(self._tid)
            if frame is not None:
                self.samples.append((time.perf_counter(), _where(frame)))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False


def profile_call(fn, cuda: bool = True):
    """(fn()'s result, the reduced trace) of one call under the profiler."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof, StackSampler() as sampler:
        t0 = time.perf_counter()
        with record_function(MARK):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, reduce(events, sampler.samples, t0)


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _loop(events, w0, w1):
    """(device seconds, replays) of the loop's graph replays in [w0, w1]:
    see the module's docstring.  (None, 0) without a graph launch."""
    launches = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime"
                and e["name"].startswith("cudaGraphLaunch")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and w0 <= e["ts"] <= w1]
    by_launch = collections.defaultdict(list)
    for k in kernels:
        corr = k.get("args", {}).get("correlation")
        if corr in launches:
            by_launch[corr].append(k)
    if not by_launch:
        return None, 0

    def graph(ks):
        ids = {k["args"].get("graph id") for k in ks}
        return ("id", ids.pop()) if len(ids) == 1 and None not in ids \
            else ("kernels", len(ks))

    last = max(by_launch.values(), key=lambda ks: min(k["ts"] for k in ks))
    key = graph(last)
    loop = [ks for ks in by_launch.values() if graph(ks) == key]
    start = min(k["ts"] for ks in loop for k in ks)
    end = max(k["ts"] + k["dur"] for ks in loop for k in ks)
    device_us = sum(k["dur"] for k in kernels if start <= k["ts"] <= end)
    return device_us / 1e6, len(loop)


def reduce(events: list, samples: list, t0: float) -> dict:
    """The trace of one profiled call (chrome-trace events) and the host's
    stack samples (perf_counter, stack) reduced to the module docstring's
    readings.  t0: perf_counter just before the call's mark opened."""
    mark = next(e for e in events if e.get("name") == MARK
                and e.get("ph") == "X"
                and e.get("cat") != "gpu_user_annotation")
    w0, w1 = mark["ts"], mark["ts"] + mark["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e.get("ph") == "X"]
    clipped = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
               for e in device if e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _union(clipped)
    busy_us = sum(e - s for s, e in busy)

    per_op = collections.Counter()
    for e in device:
        if w0 <= e["ts"] <= w1:
            per_op[e["name"][:NAME_CHARS]] += e["dur"] / 1e6

    # Gaps of the device inside the call, named by the host's samples
    # (perf_counter seconds, moved onto the trace's clock at the mark).
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    stamps = sorted(((s - t0) * 1e6 + w0, where) for s, where in samples)
    idle = collections.Counter()
    short = f"gaps under {SAMPLE_S * 1e3:g} ms"
    j = 0
    for g0, g1 in gaps:
        if g1 - g0 < SAMPLE_S * 1e6:
            idle[short] += (g1 - g0) / 1e6
            continue
        while j < len(stamps) and stamps[j][0] < g0:
            j += 1
        k, seen = j, collections.Counter()
        while k < len(stamps) and stamps[k][0] <= g1:
            seen[stamps[k][1]] += 1
            k += 1
        name = seen.most_common(1)[0][0] if seen else "no host sample"
        idle[name[:NAME_CHARS]] += (g1 - g0) / 1e6

    loop_s, replays = _loop(events, w0, w1)
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "device_ops": [[n, s] for n, s in per_op.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(TOP)],
            "loop_device_s": loop_s, "loop_replays": replays}
