"""User-facing Model API (port of hprlp_tpu/model.py: Model.from_arrays,
Model.solve, solve).

Presolve is not ported yet.  With use_presolve=True the solve takes the JAX
package's own posture for an unavailable presolver (hprlp_tpu/model.py:
141-145): one line on stderr, then the original model is solved.  MPS
input waits for a loader that does not import JAX.
"""

from __future__ import annotations

import sys
from typing import Optional

from .params import Parameters
from .problem import LpProblem
from .results import Results
from .solver.loop import solve_problem


class Model:
    """An LP model created from arrays or scipy sparse matrices."""

    def __init__(self, problem: LpProblem):
        self._problem = problem

    @property
    def problem(self) -> LpProblem:
        return self._problem

    @property
    def m(self) -> int:
        return self._problem.m

    @property
    def n(self) -> int:
        return self._problem.n

    @property
    def nnz(self) -> int:
        return self._problem.nnz

    @classmethod
    def from_arrays(cls, A, AL, AU, l, u, c, obj_constant: float = 0.0
                    ) -> "Model":
        return cls(LpProblem.from_arrays(A, AL, AU, l, u, c, obj_constant))

    def solve(self, parameters: Optional[Parameters] = None, x0=None,
              y0=None, device=None) -> Results:
        """Solve; x0/y0 warm-start in the original space.  device: a torch
        device, None for cuda:{parameters.device_number}."""
        params = parameters or Parameters()
        if params.use_presolve:
            print("[presolve] not yet ported to hprlp_tpu_torch; solving the "
                  "original model", file=sys.stderr)
        res = solve_problem(self._problem, params, x0=x0, y0=y0,
                            device=device)
        return _apply_sense(res, self._problem.objective_sense)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def solve(A, AL, AU, l, u, c, parameters: Optional[Parameters] = None,
          obj_constant: float = 0.0, device=None) -> Results:
    """One-shot solve from arrays (parity: hprlp.solve)."""
    return Model.from_arrays(A, AL, AU, l, u, c, obj_constant).solve(
        parameters, device=device)


def _apply_sense(res: Results, sense: int) -> Results:
    """Report objectives in the problem's original sense."""
    if sense == -1:
        res.primal_obj = -res.primal_obj
        res.dual_obj = -res.dual_obj
    return res
