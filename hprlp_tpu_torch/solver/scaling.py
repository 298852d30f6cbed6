"""On-device scaling pipeline: Curtis-Reid -> Ruiz -> Pock-Chambolle -> b/c.

Port of hprlp_tpu/solver/scaling.py, with the same behavioural parity with
the reference scaling (reference: src/scaling.cu:88-216) and its quirks:
  * row/col equilibration factors are the SQRT of the row inf-norm (Ruiz) or
    row 1-norm (Pock-Chambolle), clamped to 1 when < 1e-15;
  * within each Ruiz/PC pass the column norms are measured BEFORE the row
    scaling of that pass is applied (src/scaling.cu:127-135 ordering);
  * Curtis-Reid runs 20 fixed alternating log-least-squares updates on the
    ORIGINAL values, then applies exp-clamped factors (:48-67);
  * norm_b_org / norm_c_org are 1 + ||.||_2 of the pre-scaling conceptual
    b = max(|AL|,|AU|) (inf->0) and c (:114-117);
  * b/c scaling divides AL,AU,l,u by b_scale = 1+||b||, c by c_scale = 1+||c||
    (:185-201).
Each matrix pass runs as its own stage with accumulated divisors multiplied
across stages, as the JAX package stages its jits.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import CURTIS_REID_ITERS, RUIZ_ITERS
from ..ops.device_problem import LpDevice
from ..ops.sparse import (row_inf_norms, row_masked_mean, row_one_norms,
                          scale_cols, scale_rows)


@dataclasses.dataclass(frozen=True)
class ScalingInfo:
    """Parity: Scaling_info (reference: include/structs.h:266-277)."""

    row_norm: torch.Tensor  # (m_pad,) accumulated row divisors of A
    col_norm: torch.Tensor  # (n_pad,)
    b_scale: torch.Tensor  # 0-dim
    c_scale: torch.Tensor
    norm_b: torch.Tensor
    norm_c: torch.Tensor
    norm_b_org: torch.Tensor
    norm_c_org: torch.Tensor


def conceptual_b(AL: torch.Tensor, AU: torch.Tensor) -> torch.Tensor:
    """max(|AL|, |AU|) with infinities mapped to 0 (reference:
    src/cuda_kernels/HPR_cuda_kernels.cu:34-43)."""
    a = torch.where(torch.isinf(AL), 0.0, AL.abs())
    b = torch.where(torch.isinf(AU), 0.0, AU.abs())
    return torch.maximum(a, b)


def _sqrt_clamped(norms: torch.Tensor) -> torch.Tensor:
    s = torch.sqrt(norms)
    return torch.where(s < 1e-15, 1.0, s)


def scale_matrix(A, AT, use_cr: bool = True, use_ruiz: bool = True,
                 use_pc: bool = True, share=None):
    """Matrix-only scaling passes (CR -> Ruiz -> PC).

    Returns (A_scaled, AT_scaled, row_norm, col_norm) with
    A_scaled = diag(1/row_norm) A diag(1/col_norm).

    With `share` (parallel/sharded.py::ScalingShare) A and AT are one
    mesh rank's rows of them, A's from share.a0 and A^T's from share.at0:
    each per-row reduction runs on these rows, in the one-card order,
    and share.gather exchanges the ranks' results into the whole
    factors (CR: two exchanges a sweep; Ruiz, PC: one a pass, both norms
    taken before the pass scales); every pass's factors are recorded in
    share.passes.  The factors are then bitwise the one-card ones."""
    dtype, device = A.dtype, A.device
    if share is None:
        m, n, a0, at0 = A.nrows, AT.nrows, 0, 0
    else:
        m, n, a0, at0 = share.m, share.n, share.a0, share.at0
    row_norm = torch.ones(m, dtype=dtype, device=device)
    col_norm = torch.ones(n, dtype=dtype, device=device)

    def whole(a=None, at=None):
        """The whole per-row vectors of A and A^T from this process's."""
        return (a, at) if share is None else share.gather(a, at)

    def scale(r, c):
        """One pass: A's entry (i, j) times r[i], then c[j]; A^T's copy of
        it times c[j], then r[i]."""
        nonlocal A, AT
        A = scale_cols(scale_rows(A, r[a0:a0 + A.nrows]), c)
        AT = scale_cols(scale_rows(AT, c[at0:at0 + AT.nrows]), r)
        if share is not None:
            share.passes.append((r, c))

    if use_cr:
        # 20 alternating log-least-squares sweeps on the original values.
        # The 1e-300 floor underflows to 0 in f32, as it does in JAX.
        log_a = -torch.log(torch.clamp(A.vals.abs(), min=1e-300))
        log_at = -torch.log(torch.clamp(AT.vals.abs(), min=1e-300))
        cols_a = A.indices.to(torch.int64)
        cols_at = AT.indices.to(torch.int64)
        t1 = torch.zeros(m, dtype=dtype, device=device)
        t2 = torch.zeros(n, dtype=dtype, device=device)
        for _ in range(CURTIS_REID_ITERS):
            t1, _ = whole(a=row_masked_mean(A, log_a - t2[cols_a]))
            _, t2 = whole(at=row_masked_mean(AT, log_at - t1[cols_at]))
        del log_a, log_at, cols_a, cols_at
        t1 = torch.clamp(torch.exp(t1), 1e-30, 1e30)
        t2 = torch.clamp(torch.exp(t2), 1e-30, 1e30)
        # CR multiplies A by the factors, so the accumulated divisors shrink.
        row_norm = row_norm / t1
        col_norm = col_norm / t2
        scale(t1, t2)

    if use_ruiz:
        for _ in range(RUIZ_ITERS):
            # Column norms measured before the row scaling is applied
            # (reference ordering, src/scaling.cu:127-144).
            t1, t2 = whole(row_inf_norms(A), row_inf_norms(AT))
            t1, t2 = _sqrt_clamped(t1), _sqrt_clamped(t2)
            row_norm = row_norm * t1
            col_norm = col_norm * t2
            scale(1.0 / t1, 1.0 / t2)

    if use_pc:
        t1, t2 = whole(row_one_norms(A), row_one_norms(AT))
        t1, t2 = _sqrt_clamped(t1), _sqrt_clamped(t2)
        row_norm = row_norm * t1
        col_norm = col_norm * t2
        scale(1.0 / t1, 1.0 / t2)

    return A, AT, row_norm, col_norm


def _scale_vectors(lp: LpDevice, A, AT, row_norm, col_norm, use_bc: bool
                   ) -> tuple[LpDevice, ScalingInfo]:
    AL, AU, c, l, u = lp.AL, lp.AU, lp.c, lp.l, lp.u

    norm_b_org = 1.0 + torch.linalg.norm(conceptual_b(AL, AU))
    norm_c_org = 1.0 + torch.linalg.norm(c)

    AL = AL / row_norm
    AU = AU / row_norm
    c = c / col_norm
    l = l * col_norm
    u = u * col_norm

    if use_bc:
        b_scale = 1.0 + torch.linalg.norm(conceptual_b(AL, AU))
        c_scale = 1.0 + torch.linalg.norm(c)
        AL = AL / b_scale
        AU = AU / b_scale
        l = l / b_scale
        u = u / b_scale
        c = c / c_scale
    else:
        b_scale = torch.ones((), dtype=c.dtype, device=c.device)
        c_scale = torch.ones((), dtype=c.dtype, device=c.device)

    norm_b = torch.linalg.norm(conceptual_b(AL, AU))
    norm_c = torch.linalg.norm(c)

    scaled = LpDevice(A=A, AT=AT, AL=AL, AU=AU, c=c, l=l, u=u)
    info = ScalingInfo(row_norm=row_norm, col_norm=col_norm,
                       b_scale=b_scale, c_scale=c_scale,
                       norm_b=norm_b, norm_c=norm_c,
                       norm_b_org=norm_b_org, norm_c_org=norm_c_org)
    return scaled, info


def scale_problem(lp: LpDevice, use_cr: bool = True, use_ruiz: bool = True,
                  use_pc: bool = True, use_bc: bool = True, share=None
                  ) -> tuple[LpDevice, ScalingInfo]:
    """Full scaling pipeline, one stage per enabled matrix pass.  With
    `share`, lp's A and A^T are a mesh rank's row forms (scale_matrix)
    and its vectors whole; the vectors' scaling reads the whole factors."""
    A, AT = lp.A, lp.AT
    m, n = (lp.AL.numel(), lp.c.numel())
    row_norm = torch.ones(m, dtype=A.dtype, device=A.device)
    col_norm = torch.ones(n, dtype=A.dtype, device=A.device)
    for enabled, flags in ((use_cr, (True, False, False)),
                           (use_ruiz, (False, True, False)),
                           (use_pc, (False, False, True))):
        if not enabled:
            continue
        A, AT, rn, cn = scale_matrix(A, AT, *flags, share=share)
        row_norm = row_norm * rn
        col_norm = col_norm * cn
    return _scale_vectors(lp, A, AT, row_norm, col_norm, use_bc)
