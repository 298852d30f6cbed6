"""Build the port's solver objects from plain numpy data.

Starts the port from a point another implementation reached (the JAX
package's state, say), with no import of that implementation: every input
is a dict of numpy arrays and Python scalars.

  lp_device_from_numpy   {"A": coo, "AT": coo, "AL", "AU", "c", "l", "u"}
                         where coo = (rows, cols, vals, nrows, ncols) in
                         padded positions (hprlp_tpu.ops.sparse.to_coo's
                         output plus the padded shape)
  scaling_from_numpy     the ScalingInfo fields
  state_from_numpy       the SolverState fields (inner: int)
  restart_from_numpy     the RestartDev fields (first_restart: bool;
                         times, since_best, stalls: int)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.device_problem import LpDevice, csr_from_coo
from .solver.chunk import SolverState
from .solver.device_loop import RestartDev
from .solver.scaling import ScalingInfo

_INT_FIELDS = {"inner", "times", "since_best", "stalls"}
_BOOL_FIELDS = {"first_restart"}


def _tensor(name, value, dtype, device):
    if name in _BOOL_FIELDS:
        return torch.tensor(bool(value), device=device)
    if name in _INT_FIELDS:
        return torch.tensor(int(value), dtype=torch.int32, device=device)
    return torch.as_tensor(np.array(value, np.float64), device=device
                           ).to(dtype)


def _from_numpy(cls, d: dict, dtype, device):
    return cls(**{f.name: _tensor(f.name, d[f.name], dtype, device)
                  for f in dataclasses.fields(cls)})


def lp_device_from_numpy(d: dict, dtype=torch.float64, device="cpu"
                         ) -> LpDevice:
    mats = {k: csr_from_coo(*d[k], dtype=dtype, device=device)
            for k in ("A", "AT")}
    vecs = {k: _tensor(k, d[k], dtype, device)
            for k in ("AL", "AU", "c", "l", "u")}
    return LpDevice(**mats, **vecs)


def scaling_from_numpy(d: dict, dtype=torch.float64, device="cpu"
                       ) -> ScalingInfo:
    return _from_numpy(ScalingInfo, d, dtype, device)


def state_from_numpy(d: dict, dtype=torch.float64, device="cpu"
                     ) -> SolverState:
    return _from_numpy(SolverState, d, dtype, device)


def restart_from_numpy(d: dict, dtype=torch.float64, device="cpu"
                       ) -> RestartDev:
    return _from_numpy(RestartDev, d, dtype, device)
