"""The plain reference that judges a solve's answer: its relative KKT error
in float64, worked out again from the original arrays the benchmark made.

For the LP  min c'x  s.t.  AL <= A x <= AU,  l <= x <= u,  with duals y (of
the rows) and z (of the bounds), HPR-LP's stopping measure (Chen, Sun and
Toh, "HPR-LP", 2024) is the largest of

    primal  sqrt(|dist(Ax, [AL, AU])|^2 + |dist(x, [l, u])|^2) / (1 + |b|)
    dual    |c - A'y - z| / (1 + |c|)
    gap     |c'x - d(y, z)| / (1 + |c'x| + |d(y, z)|)

with b = max(|AL|, |AU|) over finite bounds (0 where infinite) and d the
dual objective, the support of the row box at y and the bound box at z.
A dual of the wrong sign on an infinite bound (y_i < 0 where AU_i = inf,
say) has no finite dual objective: here it counts as dual infeasibility
and adds nothing to d.

Plain NumPy and SciPy; it imports nothing of the program and uses nothing
the program made but the answer it judges.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _finite(v: np.ndarray) -> np.ndarray:
    return np.where(np.isinf(v), 0.0, v)


def _support(w, lo, hi):
    """(sum of w_i lo_i over w_i > 0 and w_i hi_i over w_i < 0 on finite
    bounds, the part of w that an infinite bound forbids)."""
    pos, neg = np.maximum(w, 0.0), np.minimum(w, 0.0)
    value = pos @ _finite(lo) + neg @ _finite(hi)
    bad = np.where(np.isinf(lo), pos, 0.0) + np.where(np.isinf(hi), neg, 0.0)
    return float(value), bad


def kkt(A: sp.spmatrix, AL, AU, l, u, c, x, y, z) -> dict:
    """The relative KKT error of (x, y, z), float64, with its parts and
    both objectives."""
    x, y, z = (np.asarray(v, np.float64) for v in (x, y, z))
    Ax = A @ x
    rp = np.maximum(AL - Ax, 0.0) + np.maximum(Ax - AU, 0.0)
    rb = np.maximum(l - x, 0.0) + np.maximum(x - u, 0.0)
    norm_b = 1.0 + np.linalg.norm(np.maximum(np.abs(_finite(AL)),
                                             np.abs(_finite(AU))))
    primal = float(np.sqrt(rp @ rp + rb @ rb) / norm_b)
    dy, bad_y = _support(y, AL, AU)
    dz, bad_z = _support(z, l, u)
    rd = c - A.T @ y - z
    dual = float(np.sqrt(rd @ rd + bad_y @ bad_y + bad_z @ bad_z)
                 / (1.0 + np.linalg.norm(c)))
    pobj, dobj = float(c @ x), dy + dz
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return {"kkt": max(primal, dual, gap), "primal": primal, "dual": dual,
            "gap": gap, "primal_obj": pobj, "dual_obj": dobj}


def bfloat16(v: np.ndarray) -> np.ndarray:
    """v rounded to bfloat16 (to nearest, ties to even, by way of float32)
    and back to float64: what an answer held in bfloat16 can say."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32).astype(np.float64)
