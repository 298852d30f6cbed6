"""SpMV backend autotune for a single LP.

Port of hprlp_tpu/solver/autotune.py::autotune_backends (reference:
src/main_iterate.cu:517-595): time a short chunk of iterations on the real
matrix with each backend, require a candidate to be >= 5% faster than the
best so far AND to reproduce the baseline's residual metrics within 1%
(the reference's merit check, :185-203), keep the fastest.  The probes run
on the solve's state without changing it: run_chunk is functional.

On the card the baseline is the tiled kernel (the JAX package's "lane"),
and the candidates are the CSR kernel ("gather": csrc/spmv.cu on A without
tiles) and, where a dense copy of A fits DENSE_BYTES_LIMIT and A is more
than 1% dense, a dense product ("dense").  Each probe chunk is captured in
a CUDA graph and timed by its replays between CUDA events
(graph.time_probe), so host launch time does not rank the backends.  The
JAX package's mixed pairs are tried only where its lane kernel is not
available, which on the card it always is, and its f64 lane pin has no
counterpart: the H100's f64 is native.  On the CPU no probe runs: the probe
ranks kernels, and no kernel runs there.  Nor does one from
AUTOTUNE_LANE_DIRECT_NNZ on, where the solve's ingest keeps the tiles alone
(solver/loop.py::giant_regime, CsrMatrix.tiles_only) and the other
candidates would need the CSR arrays it released.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from ..constants import DENSE_BYTES_LIMIT_SINGLE as DENSE_BYTES_LIMIT
from ..ops.device_problem import LpDevice
from ..ops.sparse import spmv_backend, with_spmv_backend
from .chunk import run_chunk
from .graph import time_probe

SPEEDUP_MIN = 1.05  # reference: >= 5% faster to switch
MERIT_RTOL = 0.01   # reference: within 1% of baseline merit
# Below this nnz no probe runs: it would cost more than it could win.
AUTOTUNE_MIN_NNZ = 10_000
# At or above this nnz the tiled kernel is taken without probing, as the
# JAX package takes its lane kernel; solver/loop.py's GIANT_LANE_FIRST_NNZ
# is this number.
AUTOTUNE_LANE_DIRECT_NNZ = 20_000_000
# A dense product reads the whole matrix: below this density it cannot win.
DENSE_MIN_DENSITY = 0.01


def _lane_ok(lp: LpDevice) -> bool:
    """Whether the tiled kernel runs, i.e. whether the probe ranks kernels
    (the JAX package's lane_ok, "not on the CPU")."""
    return lp.c.device.type == "cuda"


def _time_chunk(lp: LpDevice, probe_args, counts: dict
                ) -> tuple[float, dict]:
    """(seconds, metrics as floats) of one probe chunk run_chunk(lp,
    *probe_args), by graph.time_probe; its launches go to `counts`."""
    secs, (_, metrics) = time_probe(lambda: run_chunk(lp, *probe_args),
                                    lp.c.device, counts=counts)
    return secs, {k: float(v) for k, v in metrics.items()}


def _merit_close(a: dict, b: dict) -> bool:
    for k in ("nrm_Rp", "nrm_Rd"):
        ref = abs(b[k])
        if abs(a[k] - b[k]) > MERIT_RTOL * max(ref, 1e-30):
            return False
    return True


def set_spmv_backend(lp: LpDevice, backend: str) -> LpDevice:
    """lp with A and A^T on one SpMV backend (ops/sparse.py::
    with_spmv_backend)."""
    return dataclasses.replace(lp, A=with_spmv_backend(lp.A, backend),
                               AT=with_spmv_backend(lp.AT, backend))


def autotune_backends(lp: LpDevice, probe_args,
                      verbose: bool = False) -> LpDevice:
    """Pick the fastest SpMV backend for A and A^T.  lp carries the tiles
    (the baseline); probe_args: the rest of run_chunk's arguments (scal,
    state, sigma, lambda, restart flag, iterations).  Returns lp
    reconfigured with the winner.  After the call, autotune_backends.record
    holds {backend: probe seconds}, the choice, the candidates whose merit
    missed, and the probes' kernel launches (which the wrappers' own
    counters do not see), or None when no probe ran."""
    log = print if verbose else (lambda *a, **k: None)
    autotune_backends.record = None
    if not _lane_ok(lp) or lp.A.nnz < AUTOTUNE_MIN_NNZ:
        return lp
    if lp.A.nnz >= AUTOTUNE_LANE_DIRECT_NNZ or lp.A.vals is None:
        log(f"[autotune] nnz={lp.A.nnz} >= {AUTOTUNE_LANE_DIRECT_NNZ} (or "
            f"the tiles kept alone): tiled selected without probing")
        return lp
    itemsize = torch.empty((), dtype=lp.c.dtype).element_size()
    density = lp.A.nnz / max(1, lp.A.nrows * lp.A.ncols)
    dense_ok = (lp.A.nrows * lp.A.ncols * itemsize <= DENSE_BYTES_LIMIT
                and density > DENSE_MIN_DENSITY)
    candidates = ["gather"] + (["dense"] if dense_ok else [])

    counts = {}
    record = {"seconds": {}, "merit_rejected": [], "failed": [],
              "choice": spmv_backend(lp.A), "probe_launches": counts}
    base = spmv_backend(lp.A)
    base_time, base_metrics = _time_chunk(lp, probe_args, counts)
    record["seconds"][base] = base_time
    log(f"[autotune] {base}: {base_time * 1e3:.3f} ms")
    best, best_time = lp, base_time
    for name in candidates:
        # A probe that fails to build or run keeps the baseline, as the
        # JAX package does: the autotune only ever switches away from a
        # working backend.
        try:
            cand = set_spmv_backend(lp, name)
            t, m = _time_chunk(cand, probe_args, counts)
        except Exception as e:
            print(f"[autotune] {name}: probe failed ({type(e).__name__}: "
                  f"{e}); keeping the baseline", file=sys.stderr)
            record["failed"].append(name)
            continue
        ok = _merit_close(m, base_metrics)
        record["seconds"][name] = t
        if not ok:
            record["merit_rejected"].append(name)
        log(f"[autotune] {name}: {t * 1e3:.3f} ms"
            f"{'' if ok else '  (merit mismatch, rejected)'}")
        if ok and t * SPEEDUP_MIN < best_time:
            best, best_time = cand, t
    record["choice"] = spmv_backend(best.A)
    autotune_backends.record = record
    if best is not lp:
        log(f"[autotune] selected {record['choice']}")
    return best


autotune_backends.record = None
