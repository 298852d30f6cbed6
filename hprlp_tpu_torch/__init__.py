"""hprlp_tpu_torch -- the HPR-LP solver on PyTorch and CUDA.

A port of hprlp_tpu (JAX/XLA/Pallas, the reference) to PyTorch, with the
sparse matrix-vector product as a hand-written CUDA kernel for Hopper
(ops/tiles.py, ops/spmv.py, csrc/spmv_tiled.cu), the batched solver's
sparse matrix-matrix product as another (ops/spmm.py, csrc/spmm.cu), and
the JAX package's
host library (presolve, MPS reader) built from native/src by native.py.
It imports neither JAX nor hprlp_tpu.

Standard form (reference: include/HPRLP.h:57-62):
    minimize    c'x        s.t.   AL <= A x <= AU,   l <= x <= u
"""

import os as _os

# Allocator tuning is OPT-IN (host-global THP policy + process mallopt;
# see _malloc.py), as in the JAX package: importing the library never
# touches /sys or malloc state unless HPRLP_MALLOC_TUNE=1 asks for it;
# the CLI's --malloc-tune calls tune_malloc() itself.
if _os.environ.get("HPRLP_MALLOC_TUNE") == "1":
    from ._malloc import tune_malloc as _tune_malloc

    _tune_malloc()

from .params import Parameters
from .problem import LpProblem
from .results import BatchedResults, Results
from .io.mps import read_mps
from .model import Model, solve, solve_mps
from .modeling import (Constraint, LinearExpression, ModelBuilder, Sense,
                       TwoSidedConstraint, Variable, between, maximize,
                       minimize)
from .solver.batched import solve_batched
from .solver.loop import solve_problem

__version__ = "0.1.0"

__all__ = [
    "Parameters", "LpProblem", "Results", "BatchedResults", "Model",
    "read_mps", "solve", "solve_mps", "solve_problem", "solve_batched",
    "ModelBuilder", "Variable",
    "LinearExpression", "Constraint", "TwoSidedConstraint", "between",
    "minimize", "maximize", "Sense", "__version__",
]
