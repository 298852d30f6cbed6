"""halves_roofline: the least time of the profiled call's iterations' two
halves (roofline.py: iterations x (x-half + y-half)) over the device time
of every kernel from the first to the last kernel of the loop's graph
replays (trace.py), in %."""

from lpbench import roofline


def read(run):
    t, p = run.trace, run.profiled
    if not t or not t["loop_device_s"] or not p:
        return None
    s = run.shape
    least = p["iters"] * roofline.iteration_seconds(
        s["m"], s["n"], s["nnz"], run.traffic["dtype"], s["batch"])
    return 100.0 * least / t["loop_device_s"]
