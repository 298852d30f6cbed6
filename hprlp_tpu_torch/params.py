"""Solver parameters.

API parity with the reference HPRLP_parameters (reference:
include/structs.h:25-40) plus TPU-specific knobs (precision, sharding).

Copy of hprlp_tpu/params.py, so that one Parameters object drives either
package; tests/test_torch_copies.py pins the fields and defaults together.
The port's solver (solver/loop.py) honours every precision: "auto",
"f32", "f64" (on CUDA, "auto" is f32 at stop_tol >= 1e-5 and native f64
below) and "mixed" (f32 stages refined in host f64 with an f64 tail,
solver/refine.py; refine_stage_precision="f64" runs native f64 stages).
spmv_backend "auto" and "lane" run the tiled SpMV kernel, the port of the
lane kernels.  mesh_shape=N runs the solve on N ranks, one process per
card (gloo ranks with device="cpu"), with the tiled kernel on each rank's
column slice of A, or with "gather" and "dense" on its rows (parallel/);
it takes every spmv_backend and precision.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Parameters:
    """User-facing solver parameters.

    Fields shared with the reference solver (include/structs.h:25-40):
      max_iter, stop_tol, time_limit, device_number, check_iter,
      use_CR_scaling, use_Ruiz_scaling, use_Pock_Chambolle_scaling,
      use_bc_scaling, use_presolve.

    TPU-native additions:
      precision: "auto" | "f32" | "f64" | "mixed".  "auto" picks f64 on
        CPU backends and, on accelerators, f32 for stop_tol >= 1e-5 and
        "f64" below it.  TPUs have no native f64:
        - "f32": the fast mode (LaneELL/dense MXU backends), reliable to
          ~1e-4..1e-6 KKT;
        - "f64": the high-accuracy mode.  On TPU the hot loop runs in
          compensated double-f32 (ops/df64.py elementwise pairs + the
          df64 lane kernel, ~2^-48 relative accuracy) at ~2.15x the f32
          per-iteration cost; per-chunk reductions and non-lane backends
          use XLA-emulated f64.
        - "mixed": f32 iterations + f64 host-side iterative refinement
          (solve, measure the ORIGINAL-space KKT in f64, re-solve the
          zoomed residual problem warm-started, stitch in f64) with a
          warm-then-cold f64 tail (SURVEY §7.2 hard part 1; same
          refinement idea PDLP uses for high-accuracy runs).
      spmv_backend: "auto" | "gather" | "dense" ("xla" = alias of
        "gather").  Analogue of the reference's fused-kernel autotuner
        (src/main_iterate.cu:517-595): "auto" benchmarks the backends on
        the actual matrix at solve start (timed full chunks, >= 5% speedup
        + merit-within-1% eligibility) and keeps the fastest; "gather" is
        the bucketed-ELL gather+reduce; "dense" runs SpMV as one MXU
        matmul against the densified matrix (small/medium problems).
      mesh_shape: optional number of devices for a 1-D sharded solve; None
        runs single-device.
    """

    max_iter: int = 2**31 - 1
    stop_tol: float = 1e-4
    time_limit: float = 3600.0
    device_number: int = 0
    check_iter: int = 150
    # Parity with CUSPARSE_spmv=false / autotune_verbose=false defaults.
    spmv_backend: str = "auto"
    autotune_verbose: bool = False

    # Scaling controllers (reference defaults: all true, structs.h:34-39).
    use_CR_scaling: bool = True
    use_Ruiz_scaling: bool = True
    use_Pock_Chambolle_scaling: bool = True
    use_bc_scaling: bool = True
    use_presolve: bool = True

    # TPU-native knobs.
    precision: str = "auto"
    mesh_shape: Optional[int] = None
    verbose: bool = True
    # Iterative-refinement controls (precision="mixed").
    refine_max_stages: int = 6
    refine_stage_tol: float = 1e-6   # per-stage tolerance on the zoomed LP
    refine_zoom_cap: float = 1e12    # max cumulative zoom factor
    # Stage precision for the refinement driver: "f32" (classic mixed
    # mode) or "f64" (df64 pair stages).  "f64" is what precision="auto"
    # routes 1e-8 TPU solves to: the pair REPRESENTATION caps iterate
    # accuracy at ~2^-48, which on degenerate LP families floors the
    # direct df64 solve at ~1e-6 KKT (round-5 measurement, transport
    # family) — zooming the residual problem resets that noise scale
    # per stage, and the true KKT is certified in host f64.
    refine_stage_precision: str = "f32"

    # Internal: iteration window for stall detection (no new best KKT for
    # this many iterations ends the solve with status "STALLED").  Set by
    # the refinement driver on its f32 stages; None disables (reference
    # semantics).
    stall_window: Optional[int] = None

    # Stall RECOVERY (device-side, run_superchunk): when the KKT error has
    # not improved by >=3% for this many consecutive checkpoints, force a
    # restart from best_sigma on an alternating escape ladder.  Breaks the
    # emulated-f64 restart limit cycle on degenerate structured LPs at
    # 1e-8 (round-4 diagnosis, docs/ROADMAP.md); dormant on converging
    # solves (any 3% improvement re-arms the counter).  0 disables.  The
    # reference needs no such mechanism — its decision scalars are native
    # f64 (src/main_iterate.cu:367-404).
    stall_recovery: int = 50

    def validate(self) -> None:
        if self.precision not in ("auto", "f32", "f64", "mixed"):
            raise ValueError(f"invalid precision: {self.precision!r}")
        if self.refine_stage_precision not in ("f32", "f64"):
            raise ValueError("invalid refine_stage_precision: "
                             f"{self.refine_stage_precision!r}")
        if self.spmv_backend == "xla":
            self.spmv_backend = "gather"
        if self.spmv_backend not in ("auto", "gather", "dense", "lane"):
            raise ValueError(f"invalid spmv_backend: {self.spmv_backend!r}")
        if self.check_iter <= 1:
            raise ValueError("check_iter must be > 1")
        if self.stop_tol <= 0:
            raise ValueError("stop_tol must be positive")
