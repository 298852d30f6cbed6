"""The trace's reduction on a made-up trace: busy time as a union, the
loop found by its graph launches' correlation and not by kernel names, and
idle gaps named by the host's samples."""

import pytest

from lpbench import trace


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
            "ts": ts, "dur": 1.0, "args": {"correlation": corr}}


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.MARK,
           "ts": 1000.0, "dur": 20000.0}]
    # A probe's graph (2 kernels), eager work, then the loop's graph
    # (3 kernels a replay, one name changed between replays).
    ev += [_launch(1100, 1), _kernel("p", 1200, 100, 1),
           _kernel("q", 1300, 100, 1)]
    ev += [_kernel("eager", 2000, 500, 7)]
    for r, t in enumerate((10000, 11000, 12000)):
        ev += [_launch(t - 50, 10 + r)]
        ev += [_kernel("a" if r else "a_renamed", t, 200, 10 + r),
               _kernel("b", t + 200, 300, 10 + r),
               _kernel("c", t + 500, 100, 10 + r)]
    ev += [_kernel("between", 11700, 100, 99)]  # inside the loop's span
    ev += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
            "ts": 20500, "dur": 400, "args": {}}]
    return ev


def test_reduce_reads_busy_loop_and_gaps():
    # The host's samples: perf_counter seconds, the mark at t0 = 5.0.
    samples = [(5.0 + (ts - 1000) / 1e6, "loop.py:build_ingest")
               for ts in range(2600, 9900, 500)]
    got = trace.reduce(_events(), samples, 5.0)
    assert got["window_s"] == pytest.approx(0.02)
    busy_us = 200 + 500 + 3 * 600 + 100 + 400
    assert got["busy_s"] == pytest.approx(busy_us / 1e6)
    assert got["loop_replays"] == 3
    # From the first loop kernel to the last: the replays and "between".
    assert got["loop_device_s"] == pytest.approx((3 * 600 + 100) / 1e6)
    idle = dict(got["idle_gaps"])
    assert idle["loop.py:build_ingest"] == pytest.approx((10000 - 2500) /
                                                         1e6)
    ops = dict(got["device_ops"])
    assert ops["b"] == pytest.approx(900 / 1e6)


def test_no_graph_launch_no_loop():
    ev = [e for e in _events() if e.get("name") != "cudaGraphLaunch"]
    got = trace.reduce(ev, [], 5.0)
    assert got["loop_device_s"] is None and got["loop_replays"] == 0
