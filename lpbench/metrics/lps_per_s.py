"""lps_per_s: LPs solved to the cell's tolerance (OPTIMAL; a batched call
counts its members) over the window's seconds, on the host's clock."""


def read(run):
    return run.solved / run.window_s if run.window_s > 0 else None
