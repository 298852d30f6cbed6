"""Central numeric constants of the HPR-LP solver.

Copy of the algorithmic constants of hprlp_tpu/constants.py (the TPU layout
constants are left out); tests/test_torch_copies.py pins the two together.
They mirror the role of the reference's include/constants.h.
"""

# Bounds with magnitude at or above this value are treated as infinite.
# (reference: include/constants.h:176 NUMERICAL_INFINITY = 1e20)
NUMERICAL_INFINITY = 1e20

# Threshold used when classifying bound types (free / lower / upper / boxed).
# (reference: src/preprocess.cu:5 kInfiniteBoundThreshold = 1e90)
INFINITE_BOUND_THRESHOLD = 1e90

# Residual-check cadence (reference: include/structs.h:30 check_iter = 150).
DEFAULT_CHECK_ITER = 150

# Restart condition ratios (reference: src/main_iterate.cu:341-351).
RESTART_SUFFICIENT_RATIO = 0.2
RESTART_NECESSARY_RATIO = 0.6
RESTART_LONG_RATIO = 0.2

# Power method budget (reference: src/HPRLP.cu:86, src/power_iteration.cu:20-26).
POWER_METHOD_MAX_ITER = 5000
POWER_METHOD_TOL = 1e-4
POWER_METHOD_SAFETY = 1.01
POWER_METHOD_CHECK_EVERY = 10
POWER_METHOD_SEED = 1

# Scaling iteration counts (reference: src/scaling.cu:48 CR=20, :125 Ruiz=10).
CURTIS_REID_ITERS = 20
RUIZ_ITERS = 10

# Default stopping tolerances (reference: include/structs.h:27, :50-57).
DEFAULT_STOP_TOL = 1e-4
MILESTONE_TOLS = (1e-4, 1e-6, 1e-8)

# Budgets, in bytes of one dense copy of A, for a dense-product candidate
# (reference analogue: the fused-kernel autotuner, src/main_iterate.cu:
# 517-595).  A dense SpMV reads the whole m x n matrix for every product,
# so the single-LP budget keeps it small beside the solver's state (the
# single-LP autotuner is not ported yet).  A batched solve's dense SpMM
# (torch.matmul at full f32 or f64) reads the matrix once for all B
# members, so solver/batched.py probes it at up to 3x that size; A and A^T
# are both densified, so a probe at the limit holds 12 GiB of the H100's
# 80 GB.
DENSE_BYTES_LIMIT_SINGLE = 2 * 1024 * 1024 * 1024
DENSE_BYTES_LIMIT_BATCHED = 6 * 1024 * 1024 * 1024
