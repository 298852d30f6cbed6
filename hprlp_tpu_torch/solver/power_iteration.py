"""Power method for lambda_max(A A^T).

Port of hprlp_tpu/solver/power_iteration.py (reference:
src/power_iteration.cu:20-119, max_iter=5000, tol=1e-4, the caller applies
the 1.01 safety factor): normal random start (+1e-8), alternating A^T / A
SpMVs, convergence test every 10 iterations via ||z - lambda q||.  The
convergence test is the loop's only host read.

The start vector comes from a torch.Generator seeded with `seed`; JAX's
jax.random.normal cannot be reproduced, so a caller that needs another
start passes `z0`.
"""

from __future__ import annotations

import torch

from ..constants import (POWER_METHOD_CHECK_EVERY, POWER_METHOD_MAX_ITER,
                         POWER_METHOD_SEED, POWER_METHOD_TOL)
from ..ops.device_problem import LpDevice
from ..ops.sparse import spmv


def power_method(lp: LpDevice, tol: float = POWER_METHOD_TOL,
                 max_iter: int = POWER_METHOD_MAX_ITER,
                 seed: int = POWER_METHOD_SEED,
                 z0: torch.Tensor | None = None) -> torch.Tensor:
    """Estimate lambda_max(A A^T) of the (scaled) matrix; returns a 0-dim
    tensor on the problem's device."""
    m = lp.A.nrows
    dtype, device = lp.c.dtype, lp.c.device
    if z0 is None:
        gen = torch.Generator().manual_seed(seed)
        z0 = torch.randn(m, generator=gen, dtype=dtype) + 1e-8
    z = z0.to(device=device, dtype=dtype)
    eps = torch.finfo(dtype).eps
    lam = torch.ones((), dtype=dtype, device=device)
    i = 1
    while i <= max_iter:
        q = z * torch.rsqrt(torch.dot(z, z) + eps)
        z = spmv(lp.A, spmv(lp.AT, q))
        if i % POWER_METHOD_CHECK_EVERY == 0:
            lam = torch.dot(q, z)
            if torch.linalg.norm(z - lam * q) < tol:
                break
        i += 1
    return lam
