"""Batched shared-A solver: B LPs with the same sparse A, different vectors.

Port of hprlp_tpu/solver/batched.py (reference: src/batched_solver.cu:
939-1092 solve_batched).  The per-member data C/AL/AU/l/u are (n_pad, B) /
(m_pad, B) device tensors, row-major, so one row of an iterate holds the B
members' values contiguously; SpMV becomes SpMM over the batch axis
(ops/sparse.spmm: the hand-written CSR kernel of csrc/spmm.cu on the card,
or a dense product), and a middle iteration's two half-updates run fused
into that kernel's row write on the card (x_half, y_half); per-member
sigma, Halpern counters and restart state are (B,) tensors; converged
members are frozen with an active mask.

Differences from the single-LP path, matching the reference:
  * presolve is not applied (reference :953-955);
  * scaling runs on A only (CR/Ruiz/PC), b/c scaling per member on the host
    (reference :975-992);
  * one shared lambda_max from the scaled A (reference :994-1001), from the
    power method on the tiled SpMV (csrc/spmv_tiled.cu), as in
    solver/loop.py.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from ..constants import DENSE_BYTES_LIMIT_BATCHED
from ..ops.device_problem import (HostMaps, LpDevice, attach_tiles,
                                  build_device_problem)
from ..ops.sparse import CsrMatrix, spmm, with_backend
from ..ops.spmm import spmm_x_half, spmm_y_half
from ..ops.tiles import build_tiles
from ..params import Parameters
from ..problem import LpProblem, _normalize_inf
from ..results import BatchedResults
from .graph import time_probe
from .loop import _sync, resolve_device, resolve_dtype
from .power_iteration import power_method
from .scaling import scale_matrix

# The dense probe runs only on matrices with at least this many entries.
PROBE_MIN_NNZ = 10_000
PROBE_ITERS = 20


@dataclasses.dataclass(frozen=True)
class BatchedLpDevice:
    """Shared scaled A/AT + per-member dense vectors (parity:
    HPRLP_batched_workspace, reference: src/batched_solver.cu:479-532)."""

    A: CsrMatrix  # m_pad rows
    AT: CsrMatrix  # n_pad rows
    AL: torch.Tensor  # (m_pad, B)
    AU: torch.Tensor
    c: torch.Tensor  # (n_pad, B)
    l: torch.Tensor
    u: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BatchedState:
    x: torch.Tensor  # (n_pad, B)
    y: torch.Tensor  # (m_pad, B)
    last_x: torch.Tensor
    last_y: torch.Tensor
    x_bar: torch.Tensor
    y_bar: torch.Tensor
    z_bar: torch.Tensor
    y_obj: torch.Tensor
    inner: torch.Tensor  # (B,) int32


def init_batched_state(lp: BatchedLpDevice) -> BatchedState:
    zn = torch.zeros_like(lp.c)
    zm = torch.zeros_like(lp.AL)
    return BatchedState(x=zn, y=zm, last_x=zn, last_y=zm, x_bar=zn,
                        y_bar=zm, z_bar=zn, y_obj=zm,
                        inner=torch.zeros(lp.c.shape[1], dtype=torch.int32,
                                          device=lp.c.device))


def _bfactors(inner, dtype):
    f1 = 1.0 / (inner.to(dtype) + 2.0)
    return f1, 1.0 - f1


def _bx_half(lp, x, y, last_x, sigma, f1, f2):
    ATy = spmm(lp.AT, y)
    z_tmp = x + sigma * (ATy - lp.c)
    x_bar = torch.clamp(z_tmp, lp.l, lp.u)
    x_hat = 2.0 * x_bar - x
    return f2 * x_hat + f1 * last_x, x_hat, x_bar, z_tmp


def _by_half(lp, y, x_hat, last_y, lam_sigma, f1, f2):
    Ax = spmm(lp.A, x_hat)
    v = Ax - lam_sigma * y
    d = torch.maximum(lp.AL - v, torch.clamp(lp.AU - v, max=0.0))
    y_bar = d / lam_sigma
    y_hat = 2.0 * y_bar - y
    return f2 * y_hat + f1 * last_y, y_bar, v + d


def x_half_plain(lp, x, y, last_x, sigma, inner, t: int, active):
    """A middle iteration's x-half in plain PyTorch: _bx_half, then the
    frozen members' x kept.  sigma: (1, B); inner: (B,) int32, the Halpern
    counters at the first middle iteration; t: this iteration's index
    among them (an active member's counter has advanced by t); active:
    (B,) bool.  Returns (x_new, x_hat)."""
    f1, f2 = _bfactors(torch.where(active, inner + t, inner), x.dtype)
    x_new, x_hat, _, _ = _bx_half(lp, x, y, last_x, sigma, f1, f2)
    return torch.where(active[None, :], x_new, x), x_hat


def y_half_plain(lp, y, x_hat, last_y, lam_sigma, inner, t: int, active):
    """A middle iteration's y-half in plain PyTorch: _by_half, then the
    frozen members' y kept; arguments as for x_half_plain, lam_sigma
    (1, B).  Returns y_new."""
    f1, f2 = _bfactors(torch.where(active, inner + t, inner), y.dtype)
    y_new, _, _ = _by_half(lp, y, x_hat, last_y, lam_sigma, f1, f2)
    return torch.where(active[None, :], y_new, y)


def _fused(M: CsrMatrix, v: torch.Tensor) -> bool:
    """The rule of ops/sparse.spmm: a dense copy keeps the plain ops around
    torch.matmul; else a CUDA tensor goes to the fused kernel (which raises
    on failure) and a CPU tensor to the plain version."""
    if M.dense is None and v.device.type == "cuda":
        return True
    if M.dense is not None or v.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {v.device}")


def x_half(lp, x, y, last_x, sigma, inner, t: int, active):
    """x_half_plain, fused into A^T y's row write on the card
    (ops/spmm.spmm_x_half)."""
    if _fused(lp.AT, x):
        return spmm_x_half(lp.AT, y, x, last_x, lp.c, lp.l, lp.u,
                           sigma.reshape(-1), inner, active, t)
    return x_half_plain(lp, x, y, last_x, sigma, inner, t, active)


def y_half(lp, y, x_hat, last_y, lam_sigma, inner, t: int, active):
    """y_half_plain, fused into A x_hat's row write on the card
    (ops/spmm.spmm_y_half)."""
    if _fused(lp.A, y):
        return spmm_y_half(lp.A, x_hat, y, last_y, lp.AL, lp.AU,
                           lam_sigma.reshape(-1), inner, active, t)
    return y_half_plain(lp, y, x_hat, last_y, lam_sigma, inner, t, active)


def _bgap_parts(lp, dx, dy):
    A_dx = spmm(lp.A, dx)
    return ((A_dx * dy).sum(dim=0), (dy * dy).sum(dim=0),
            (dx * dx).sum(dim=0))


def _bmetrics(lp, row_norm, col_norm, x_bar, y_bar, z_bar, y_obj, dx, dy,
              last_x, last_y):
    """Per-member residual ingredients; every value is a (B,) tensor
    (parity: compute_residuals batched, reference:
    src/batched_solver.cu:578-623)."""
    Ax_bar = spmm(lp.A, x_bar)
    Rp = (torch.maximum(lp.AL - Ax_bar, torch.clamp(lp.AU - Ax_bar, max=0.0))
          * row_norm[:, None])
    ATy_bar = spmm(lp.AT, y_bar)
    Rd = (lp.c - ATy_bar - z_bar) * col_norm[:, None]
    gap_dot, gap_dy2, gap_dx2 = _bgap_parts(lp, dx, dy)
    viol = torch.where(x_bar < lp.l, lp.l - x_bar,
                       torch.where(x_bar > lp.u, x_bar - lp.u, 0.0))

    def nrm(M):
        return torch.sqrt((M * M).sum(dim=0))

    return {
        "dot_c_xbar": (lp.c * x_bar).sum(dim=0),
        "dot_yobj_ybar": (y_obj * y_bar).sum(dim=0),
        "dot_xbar_zbar": (x_bar * z_bar).sum(dim=0),
        "nrm_Rd": nrm(Rd),
        "nrm_Rp": nrm(Rp),
        "gap_dot": gap_dot,
        "gap_dy2": gap_dy2,
        "gap_dx2": gap_dx2,
        "move_x": nrm(x_bar - last_x),
        "move_y": nrm(y_bar - last_y),
        "nrm_lu_viol": nrm(viol / col_norm[:, None]),
    }


def run_batched_chunk(lp: BatchedLpDevice, row_norm, col_norm,
                      state: BatchedState, sigma, lambda_max, restart_flag,
                      active, n_iters: int):
    """n_iters (>= 2) HPR iterations over all members + residual check.

    sigma, lambda_max: (B,); restart_flag, active: (B,) bool.  Frozen
    members keep their state bit for bit (reference active-mask kernels,
    src/batched_solver.cu:122-323).  Returns (new_state, metrics of (B,)
    tensors).
    """
    dtype = lp.c.dtype
    sigma = sigma.to(dtype)[None, :]
    lam_sigma = lambda_max.to(dtype) * sigma
    act = active[None, :]

    rf = restart_flag[None, :]
    x = torch.where(rf, state.x_bar, state.x)
    y = torch.where(rf, state.y_bar, state.y)
    last_x = torch.where(rf, state.x_bar, state.last_x)
    last_y = torch.where(rf, state.y_bar, state.last_y)
    inner = torch.where(restart_flag, 0, state.inner)

    def freeze(new, old):
        return torch.where(act, new, old)

    # First iteration (check-style, for the post-restart gap).
    f1, f2 = _bfactors(inner, dtype)
    x1, x_hat, x_bar1, _ = _bx_half(lp, x, y, last_x, sigma, f1, f2)
    y1, y_bar1, _ = _by_half(lp, y, x_hat, last_y, lam_sigma, f1, f2)
    fs_dot, fs_dy2, fs_dx2 = _bgap_parts(lp, x - x_bar1, y - y_bar1)
    x1, y1 = freeze(x1, x), freeze(y1, y)
    inner = torch.where(active, inner + 1, inner)

    # Middle iterations: plain updates, each half fused into its SpMM on
    # the card; the Halpern counters advance by one per iteration.
    x2, y2 = x1, y1
    for t in range(n_iters - 2):
        x2, x_hat = x_half(lp, x2, y2, last_x, sigma, inner, t, active)
        y2 = y_half(lp, y2, x_hat, last_y, lam_sigma, inner, t, active)
    inner = torch.where(active, inner + (n_iters - 2), inner)

    # Final iteration (check-style) + per-member residuals.
    f1, f2 = _bfactors(inner, dtype)
    x_f, x_hat, x_bar, z_tmp = _bx_half(lp, x2, y2, last_x, sigma, f1, f2)
    z_bar = (x_bar - z_tmp) / sigma
    y_f, y_bar, y_obj = _by_half(lp, y2, x_hat, last_y, lam_sigma, f1, f2)

    x_f, y_f = freeze(x_f, x2), freeze(y_f, y2)
    x_bar = freeze(x_bar, state.x_bar)
    y_bar = freeze(y_bar, state.y_bar)
    z_bar = freeze(z_bar, state.z_bar)
    y_obj = freeze(y_obj, state.y_obj)
    inner = torch.where(active, inner + 1, inner)

    metrics = _bmetrics(lp, row_norm, col_norm, x_bar, y_bar, z_bar, y_obj,
                        x2 - x_bar, y2 - y_bar, last_x, last_y)
    metrics["fs_dot"] = fs_dot
    metrics["fs_dy2"] = fs_dy2
    metrics["fs_dx2"] = fs_dx2

    new_state = BatchedState(x=x_f, y=y_f, last_x=last_x, last_y=last_y,
                             x_bar=x_bar, y_bar=y_bar, z_bar=z_bar,
                             y_obj=y_obj, inner=inner)
    return new_state, metrics


def initial_bmetrics(lp: BatchedLpDevice, row_norm, col_norm,
                     state: BatchedState):
    """Residual metrics of the initial bars, as in the single-LP path."""
    zn = torch.zeros_like(state.x)
    zm = torch.zeros_like(state.y)
    m = _bmetrics(lp, row_norm, col_norm, state.x_bar, state.y_bar,
                  state.z_bar, state.y_obj, zn, zm, state.last_x,
                  state.last_y)
    z = torch.zeros(state.inner.shape[0], dtype=state.x.dtype,
                    device=state.x.device)
    m["fs_dot"] = z
    m["fs_dy2"] = z
    m["fs_dx2"] = z
    return m


def _check_supported(params: Parameters) -> None:
    if params.mesh_shape:
        raise NotImplementedError(
            "mesh_shape (batched solves over several devices) is not ported "
            "yet (ROADMAP.md queue 1 item 6, multi-GPU)")


def _probe_dense(lp, row_norm_d, col_norm_d, state, sigma, lam, log):
    """The batched autotune (reference protocol: >= 5% faster and merit
    within 1%, src/main_iterate.cu:517-595): PROBE_ITERS iterations of
    every member on the kernel and on dense copies of A and A^T, each
    timed by graph.time_probe (on the card, replays of a captured CUDA
    graph between CUDA events: device time, which host noise does not
    move).  Returns (lp to solve with, record); the record's
    "probe_launches" are the probes' kernel launches, which the wrappers'
    own counters do not see.  A failing kernel raises; only the dense
    candidate's allocation may fail, and then the kernel is kept."""
    B = sigma.shape[0]
    device = lp.c.device
    probe = (sigma, lam, torch.zeros(B, dtype=torch.bool, device=device),
             torch.ones(B, dtype=torch.bool, device=device))
    counts = {}

    def time_cand(cand):
        secs, (_, mm) = time_probe(
            lambda: run_batched_chunk(cand, row_norm_d, col_norm_d, state,
                                      *probe, PROBE_ITERS),
            device, counts=counts)
        return secs, mm["nrm_Rp"].cpu().numpy().astype(np.float64)

    t_k, rp_k = time_cand(lp)
    record = {"kernel_ms": t_k * 1e3, "dense_ms": None, "merit_ok": None,
              "backend": "gather", "probe_launches": counts}
    try:
        dense_lp = dataclasses.replace(lp, A=with_backend(lp.A, "dense"),
                                       AT=with_backend(lp.AT, "dense"))
        t_d, rp_d = time_cand(dense_lp)
    except torch.cuda.OutOfMemoryError as e:
        print(f"[solve_batched] dense probe: out of device memory, the "
              f"kernel is kept ({e})", file=sys.stderr)
        return lp, record
    merit_ok = bool(np.allclose(rp_d, rp_k, rtol=0.01, atol=1e-30))
    record.update(dense_ms=t_d * 1e3, merit_ok=merit_ok)
    log(f"[autotune] batched gather: {t_k * 1e3:.2f} ms, "
        f"dense: {t_d * 1e3:.2f} ms"
        f"{'' if merit_ok else ' (merit mismatch)'}")
    if merit_ok and t_d * 1.05 < t_k:
        record["backend"] = "dense"
        return dense_lp, record
    return lp, record


@dataclasses.dataclass(frozen=True)
class BatchedSetup:
    """A batched solve's device problem and its host-side scaling: what
    solve_batched builds before the power method."""

    lp: BatchedLpDevice
    lp0: LpDevice  # the scaled A and A^T with their SpMV tiles
    maps: HostMaps
    row_norm: torch.Tensor  # (m_pad,) accumulated row divisors of A
    col_norm: torch.Tensor  # (n_pad,)
    b_scale: np.ndarray  # (B,) each
    c_scale: np.ndarray
    norm_b: np.ndarray
    norm_c: np.ndarray
    norm_b_org: np.ndarray
    norm_c_org: np.ndarray
    dense_ok: bool  # a dense copy of A fits DENSE_BYTES_LIMIT_BATCHED


def setup_batched(A, C, AL, AU, l, u, params: Parameters, device,
                  dtype) -> BatchedSetup:
    """Layout and upload, matrix scaling on the device, per-member vector
    scaling on the host.  C, AL, AU, l, u: validated float64 arrays."""
    B = C.shape[1]
    # Shared-A layout: the single-LP builder with the first member's
    # vectors (only its matrices and maps are used).
    base = LpProblem.from_arrays(A, AL[:, 0], AU[:, 0], l[:, 0], u[:, 0],
                                 C[:, 0])
    lp0, maps = build_device_problem(base, dtype=dtype, device=device)
    m_pad, n_pad = lp0.m, lp0.n
    tiles = (build_tiles(lp0.A), build_tiles(lp0.AT))

    # Scale A once (CR/Ruiz/PC only; reference forces bc off for the shared
    # pass, src/batched_solver.cu:975-981), then gather the scaled values
    # into the SpMV tiles for the power method.
    A_s, AT_s, row_norm_d, col_norm_d = scale_matrix(
        lp0.A, lp0.AT, params.use_CR_scaling, params.use_Ruiz_scaling,
        params.use_Pock_Chambolle_scaling)
    lp0 = attach_tiles(dataclasses.replace(lp0, A=A_s, AT=AT_s), *tiles)
    del tiles
    A_s, AT_s = lp0.A, lp0.AT

    want = params.spmv_backend
    itemsize = torch.empty((), dtype=dtype).element_size()
    dense_ok = m_pad * n_pad * itemsize <= DENSE_BYTES_LIMIT_BATCHED
    if want == "dense" and dense_ok:
        A_s = with_backend(A_s, "dense")
        AT_s = with_backend(AT_s, "dense")
    elif want == "lane":
        print("[solve_batched] no lane SpMM lowering; the batched "
              "backends are gather/dense (autotuned)", file=sys.stderr)
    row_norm = row_norm_d.cpu().numpy().astype(np.float64)
    col_norm = col_norm_d.cpu().numpy().astype(np.float64)

    # Per-member vector scaling on the host (reference :810-864): row/col
    # norms, then per-member b/c scales.
    def scatter(arr_2d, pos, size, fill):
        out_h = np.full((size, B), fill)
        out_h[pos, :] = arr_2d
        return out_h

    AL_p = scatter(AL, maps.row_pos, m_pad, -np.inf)
    AU_p = scatter(AU, maps.row_pos, m_pad, np.inf)
    C_p = scatter(C, maps.col_pos, n_pad, 0.0)
    l_p = scatter(l, maps.col_pos, n_pad, 0.0)
    u_p = scatter(u, maps.col_pos, n_pad, 0.0)

    def bnorm(ALm, AUm):
        return np.linalg.norm(
            np.maximum(np.where(np.isinf(ALm), 0.0, np.abs(ALm)),
                       np.where(np.isinf(AUm), 0.0, np.abs(AUm))), axis=0)

    # Original-space residual denominators come from the PRE-scaling
    # vectors (parity: single-LP scale_problem and the reference's batched
    # path, src/batched_solver.cu:817-819).
    norm_b_org = 1.0 + bnorm(AL_p, AU_p)
    norm_c_org = 1.0 + np.linalg.norm(C_p, axis=0)

    AL_p /= row_norm[:, None]
    AU_p /= row_norm[:, None]
    C_p /= col_norm[:, None]
    l_p *= col_norm[:, None]
    u_p *= col_norm[:, None]

    if params.use_bc_scaling:
        b_scale = 1.0 + bnorm(AL_p, AU_p)
        c_scale = 1.0 + np.linalg.norm(C_p, axis=0)
        AL_p /= b_scale
        AU_p /= b_scale
        l_p /= b_scale
        u_p /= b_scale
        C_p /= c_scale
    else:
        b_scale = np.ones(B)
        c_scale = np.ones(B)

    def dev(arr):
        return torch.as_tensor(arr, device=device).to(dtype)

    lp = BatchedLpDevice(A=A_s, AT=AT_s, AL=dev(AL_p), AU=dev(AU_p),
                         c=dev(C_p), l=dev(l_p), u=dev(u_p))
    return BatchedSetup(
        lp=lp, lp0=lp0, maps=maps, row_norm=row_norm_d, col_norm=col_norm_d,
        b_scale=b_scale, c_scale=c_scale, norm_b=bnorm(AL_p, AU_p),
        norm_c=np.linalg.norm(C_p, axis=0), norm_b_org=norm_b_org,
        norm_c_org=norm_c_org, dense_ok=dense_ok)


def initial_sigma(su: BatchedSetup) -> np.ndarray:
    """Per-member starting sigma = ||b|| / ||c|| of the scaled vectors."""
    return np.where((su.norm_b > 1e-8) & (su.norm_c > 1e-8),
                    su.norm_b / np.maximum(su.norm_c, 1e-300), 1.0)


def solve_batched(A, C, AL, AU, l, u, obj_constants=None,
                  params: Parameters | None = None,
                  device=None) -> BatchedResults:
    """Solve B LPs sharing the sparse matrix A.

    C, l, u: (n, B); AL, AU: (m, B); obj_constants: (B,) or None.
    Returns BatchedResults with column-major-layout solutions (parity:
    reference bindings solve_batched, bindings/python/hprlp/solver.py:335,
    src/batched_solver.cu:939).  device: a torch device; None means
    cuda:{params.device_number}, and raises without CUDA.
    precision="mixed" solves in f64 on the CPU and f32 on CUDA with no
    refinement, as the JAX package's solve_batched does.

    spmv_backend: "auto" and "gather" run the CSR SpMM kernel; "auto" on
    the card also probes a dense product (below); "dense" runs the dense
    product when it fits DENSE_BYTES_LIMIT_BATCHED; "lane" has no SpMM and
    runs the kernel.  After the call, solve_batched.probe holds the dense
    probe's record, or None when no probe ran, and
    solve_batched.capture_time the seconds of the CUDA graph's warm-up and
    capture (None on the CPU).
    """
    params = params or Parameters()
    params.validate()
    _check_supported(params)
    device = resolve_device(params, device)
    dtype = resolve_dtype(params, device)
    log = print if params.verbose else (lambda *a, **k: None)
    solve_batched.probe = None
    solve_batched.capture_time = None

    C = np.asarray(C, np.float64)
    AL = _normalize_inf(np.asarray(AL, np.float64))
    AU = _normalize_inf(np.asarray(AU, np.float64))
    l = _normalize_inf(np.asarray(l, np.float64))
    u = _normalize_inf(np.asarray(u, np.float64))
    if C.ndim != 2:
        raise ValueError("C must be (n, batch)")
    n, B = C.shape
    m = AL.shape[0]
    for name, arr, shape in (("AL", AL, (m, B)), ("AU", AU, (m, B)),
                             ("l", l, (n, B)), ("u", u, (n, B))):
        if arr.shape != shape:
            raise ValueError(f"{name} has shape {arr.shape}, expected {shape}")
    if np.any(AL > AU) or np.any(l > u):
        raise ValueError("infeasible bounds: AL > AU or l > u in some member")
    obj_constants = (np.zeros(B) if obj_constants is None
                     else np.asarray(obj_constants, np.float64))

    out = BatchedResults(m=m, n=n, batch_size=B)
    t_setup = time.perf_counter()
    su = setup_batched(A, C, AL, AU, l, u, params, device, dtype)
    lp, maps = su.lp, su.maps
    row_norm_d, col_norm_d = su.row_norm, su.col_norm
    row_norm = row_norm_d.cpu().numpy().astype(np.float64)
    col_norm = col_norm_d.cpu().numpy().astype(np.float64)
    b_scale, c_scale = su.b_scale, su.c_scale
    norm_b_org, norm_c_org = su.norm_b_org, su.norm_c_org
    _sync(device)
    out.setup_time = time.perf_counter() - t_setup
    log(f"Batched setup time = {out.setup_time:.2f} seconds (B={B})")

    t_pm = time.perf_counter()
    lam_shared = max(float(power_method(su.lp0)) * 1.01, 1e-12)
    out.power_time = time.perf_counter() - t_pm
    sigma = initial_sigma(su)
    dense_ok = su.dense_ok
    del su

    def dev(arr):
        return torch.as_tensor(arr, device=device).to(dtype)

    sigma_d = dev(sigma)
    lam_d = dev(np.full(B, lam_shared))
    state = init_batched_state(lp)

    # The batched autotune between the SpMM kernel and a dense product, on
    # the card only, as the JAX package probes on accelerators only.
    if (params.spmv_backend == "auto" and dense_ok
            and device.type == "cuda" and lp.A.nnz >= PROBE_MIN_NNZ):
        lp, solve_batched.probe = _probe_dense(
            lp, row_norm_d, col_norm_d, state, sigma_d, lam_d, log)

    from .batched_device_loop import (capture_batched_superchunk,
                                      init_batched_restart_dev,
                                      run_batched_superchunk)

    status = np.array(["CONTINUE"] * B, object)
    iters = np.zeros(B, np.int64)
    final_kkt = np.full(B, np.inf)
    final_gap = np.full(B, np.inf)
    final_pobj = np.zeros(B)

    metrics_prev = initial_bmetrics(lp, row_norm_d, col_norm_d, state)
    rd = init_batched_restart_dev(sigma_d, dtype)
    b_scale_d, c_scale_d = dev(b_scale), dev(c_scale)
    nb_d, nc_d = dev(norm_b_org), dev(norm_c_org)
    oc_d = dev(obj_constants)
    obj_scale = b_scale * c_scale
    check = params.check_iter

    def derive(m_k, at_it):
        pobj = obj_scale * m_k["dot_c_xbar"] + obj_constants
        dobj = obj_scale * (m_k["dot_yobj_ybar"]
                            + m_k["dot_xbar_zbar"]) + obj_constants
        rel_gap = np.abs(pobj - dobj) / (1.0 + np.abs(pobj) + np.abs(dobj))
        err_Rd = c_scale * m_k["nrm_Rd"] / norm_c_org
        err_Rp = b_scale * m_k["nrm_Rp"] / norm_b_org
        if at_it == 0:
            err_Rp = np.maximum(err_Rp, b_scale * m_k["nrm_lu_viol"])
        kkt = np.maximum(np.maximum(err_Rd, err_Rp), rel_gap)
        return pobj, rel_gap, kkt

    def finish():
        _sync(device)
        out.solve_time = elapsed()
        out.time = out.setup_time + out.solve_time
        out.iter = iters
        out.residuals = final_kkt
        out.gap = final_gap
        out.primal_obj = final_pobj
        out.status = list(status)
        # Un-scale solutions (reference :887-935).
        x_s, y_s, z_s = (v.cpu().numpy().astype(np.float64)
                         for v in (state.x_bar, state.y_bar, state.z_bar))
        x = (b_scale[None, :] * x_s / col_norm[:, None])[maps.col_pos, :]
        y = (c_scale[None, :] * y_s / row_norm[:, None])[maps.row_pos, :]
        z = (c_scale[None, :] * z_s * col_norm[:, None])[maps.col_pos, :]
        out.x = np.asfortranarray(x)
        out.y = np.asfortranarray(y)
        out.z = np.asfortranarray(z)
        return out

    n_quiet = 1 if params.verbose else 32
    n_quiet = max(1, min(n_quiet, (params.max_iter + check - 1) // check))

    # On the card, one chunk boundary captured in a CUDA graph (warmed up
    # on a copy of the state) before the algorithm clock, as in
    # solver/loop.py.
    graph = None
    if device.type == "cuda":
        graph = capture_batched_superchunk(
            lp, row_norm_d, col_norm_d, state, rd, sigma_d, lam_d,
            torch.ones(B, dtype=torch.bool, device=device), metrics_prev,
            b_scale_d, c_scale_d, nb_d, nc_d, oc_d, params.stop_tol, check,
            n_quiet)
        solve_batched.capture_time = graph.capture_s
        log(f"CUDA graph capture time = {graph.capture_s:.2f} seconds")

    # --- algorithm clock: iteration work only from here on ---
    _sync(device)
    t_alg = time.perf_counter()

    def elapsed():
        return time.perf_counter() - t_alg

    # Iteration-0 bookkeeping.
    m0 = {k: v.cpu().numpy().astype(np.float64)
          for k, v in metrics_prev.items()}
    pobj, rel_gap, kkt = derive(m0, 0)
    done0 = kkt < params.stop_tol
    status[done0] = "OPTIMAL"
    final_kkt[:] = kkt
    final_gap[:] = rel_gap
    final_pobj[:] = pobj
    active_h = ~done0
    active_d = torch.as_tensor(active_h, device=device)
    log(f"iter {0:6d}  active {int(active_h.sum()):4d}/{B}  "
        f"max_kkt {np.nanmax(kkt):.2e}  time {elapsed():.2f}s")
    it = 0

    while active_h.any():
        if it >= params.max_iter:
            status[active_h] = "ITER_LIMIT"
            return finish()
        if elapsed() > params.time_limit:
            status[active_h] = "TIME_LIMIT"
            return finish()

        n_chunks = max(1, min(n_quiet,
                              (params.max_iter - it + check - 1) // check))
        (state, rd, sigma_d, lam_d, active_d, metrics_prev, stacked,
         k_done) = run_batched_superchunk(
            lp, row_norm_d, col_norm_d, state, rd, sigma_d, lam_d, active_d,
            metrics_prev, it, b_scale_d, c_scale_d, nb_d, nc_d, oc_d,
            params.stop_tol, n_chunks, check, graph)

        for k in range(k_done):
            it += check
            was_active = stacked["active"][k] > 0.5
            m_k = {key: stacked[key][k] for key in stacked}
            pobj, rel_gap, kkt = derive(m_k, it)
            final_kkt = np.where(was_active, kkt, final_kkt)
            final_gap = np.where(was_active, rel_gap, final_gap)
            final_pobj = np.where(was_active, pobj, final_pobj)
            iters = np.where(was_active, it, iters)
            newly_opt = was_active & (kkt < params.stop_tol)
            status[newly_opt] = "OPTIMAL"
            active_h = was_active & ~newly_opt
            if params.verbose:
                log(f"iter {it:6d}  active {int(active_h.sum()):4d}/{B}  "
                    f"max_kkt {np.nanmax(kkt):.2e}  time {elapsed():.2f}s")

        # Reconcile with the device's own freeze decisions (the last
        # chunk's active_after).  The device stop test runs in the solve
        # dtype while the host recomputes kkt in f64 from the same metrics;
        # a member within rounding of stop_tol can pass one test and fail
        # the other.  The device decision is authoritative (it is the one
        # that freezes iteration): without this, a device-frozen,
        # host-active member wedges the loop until time_limit.
        dev_active = stacked["active_after"][k_done - 1] > 0.5
        status[active_h & ~dev_active] = "OPTIMAL"
        active_h &= dev_active
        # And push host-side freezes back to the device so both views agree
        # on the next call.
        if not np.array_equal(dev_active, active_h):
            active_d = torch.as_tensor(active_h, device=device)

    log(f"iter {it:6d}  all {B} members converged  time {elapsed():.2f}s")
    return finish()


solve_batched.probe = None
solve_batched.capture_time = None
