"""device_idle: the share of the profiled call's wall in which no device
operation runs (kernel, copy or fill; trace.py), in %."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
