"""peak_mem_gib: the largest torch.cuda.max_memory_allocated() of any call
in the window, the peak reset before each call, in GiB."""


def read(run):
    peaks = [c["peak_bytes"] for c in run.calls]
    return max(peaks) / 2**30 if peaks and max(peaks) > 0 else None
