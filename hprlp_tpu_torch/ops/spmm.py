"""SpMM, Y = A X for the batched solver: the hand-written Hopper kernels,
their launch plan and their plain versions.

`csr_spmm` launches `csrc/spmm.cu`'s solver design (slice-major grid under
an L2 budget, row blocks, a register cap) on a CsrMatrix and a
dense row-major X of shape (ncols, B), f32 or f64, any B >= 1;
`spmm_reference` is its contract in plain PyTorch.  `spmm_x_half` and
`spmm_y_half` run the same kernel with the batched HPR middle iteration's
x- or y-half-update fused into its row write; their plain versions are
solver/batched.py::x_half_plain and y_half_plain.  `csr_spmm_rowwise`
launches the previous design (`csrc/spmm_rowwise.cu`: row-major tasks),
kept in its own library to be timed beside the new one.  The JAX package
has no Pallas kernel here: it computes the product as an XLA gather einsum
(hprlp_tpu/ops/sparse.py:594-608).  Each library builds with nvcc on first
use, by ops/spmv.py's rule, and loads with ctypes; nothing is built when
this module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os

import torch

from .spmv import _HERE, build, check_csr_matrix, row_of_entry

SOURCE = os.path.join(_HERE, "csrc", "spmm.cu")
ROWWISE_SOURCE = os.path.join(_HERE, "csrc", "spmm_rowwise.cu")
WARP = 32
BLOCK = 256  # threads per block (csrc/spmm.cu kBlock)
# The bytes of X that one column slice keeps live (ncols x slice width x
# itemsize): about two thirds of the H100's 50 MB L2, i.e. 64 f32 or 32 f64
# columns of 131,072 rows.  Without it, B = 256 is 1.3x slower on an H100
# (PERF.md section 6).
L2_BUDGET = 32 * 2**20
# csrc/spmm.cu's epilogues: Y = A X, or a fused half.
STORE, X_HALF, Y_HALF = 0, 1, 2


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build(SOURCE))
    i, ptr = ctypes.c_int, ctypes.c_void_p
    lib.hprlp_spmm.argtypes = [i] * 9 + [ptr] * 15
    lib.hprlp_spmm.restype = i
    lib.hprlp_spmm_error_string.argtypes = [i]
    lib.hprlp_spmm_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _rowwise_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build(ROWWISE_SOURCE))
    i, ptr = ctypes.c_int, ctypes.c_void_p
    lib.hprlp_csr_spmm.argtypes = [i] * 6 + [ptr] * 6
    lib.hprlp_csr_spmm.restype = i
    lib.hprlp_spmm_error_string.argtypes = [i]
    lib.hprlp_spmm_error_string.restype = ctypes.c_char_p
    return lib


def spmm_plan(B: int, itemsize: int, address: int, ncols: int = 0
              ) -> tuple[int, int, int]:
    """(G, V, n_slices) of a launch for B columns of `itemsize` bytes, the
    operands at `address` (or the OR of their addresses): V columns per
    lane, the widest load of at most 16 bytes that B and the address allow;
    G lanes per (row, slice), the least power of two with G * V >= B, at
    most a warp, and, given ncols > 0, no wider than keeps a slice's window
    of X (ncols x G x V x itemsize bytes) within L2_BUDGET; n_slices slices
    of G * V columns cover B.  With ncols = 0 (no cap) this is the previous
    design's plan."""
    V = 1
    for v in (4, 2):
        if v * itemsize <= 16 and B % v == 0 and address % (v * itemsize) == 0:
            V = v
            break
    G = 1
    while G < WARP and G * V < B and (
            not ncols or ncols * 2 * G * V * itemsize <= L2_BUDGET):
        G *= 2
    return G, V, -(-B // (G * V))


def spmm_grid(nrows: int, G: int, n_slices: int) -> tuple[int, int]:
    """The solver design's grid: (row blocks, slices).  Blocks start in
    index order, rows fastest, so the slices run one after another; a block
    owns BLOCK // G consecutive rows of one slice."""
    return -(-nrows // (BLOCK // G)), n_slices


@functools.lru_cache(maxsize=1024)
def _launch_plan(nrows: int, ncols: int, B: int, itemsize: int,
                 align: int) -> tuple[int, int, int, int]:
    """(G, V, grid_x, n_slices) for one shape, dtype and alignment (the
    operands' addresses modulo 16)."""
    G, V, n_slices = spmm_plan(B, itemsize, align, ncols)
    return (G, V, *spmm_grid(nrows, G, n_slices))


def check_spmm_args(A, X: torch.Tensor) -> None:
    """The checks csr_spmm makes before a launch."""
    check_csr_matrix(A, X)
    if X.dim() != 2 or X.shape[0] != A.ncols or X.shape[1] < 1 \
            or not X.is_contiguous():
        raise ValueError(f"X must be contiguous of shape ({A.ncols}, B) with "
                         f"B >= 1, got {tuple(X.shape)}")


def check_half_args(A, X: torch.Tensor, rows: dict, scal: torch.Tensor,
                    inner: torch.Tensor, active: torch.Tensor) -> None:
    """The checks the fused halves make before a launch: X as for
    csr_spmm; each of `rows` (name -> tensor) contiguous (A.nrows, B) of
    X's dtype and device; scal (B,) of that dtype, inner (B,) int32 and
    active (B,) bool on that device."""
    check_spmm_args(A, X)
    B = X.shape[1]
    wants = [(name, t, (A.nrows, B), X.dtype) for name, t in rows.items()]
    wants += [("scal", scal, (B,), X.dtype), ("inner", inner, (B,),
                                              torch.int32),
              ("active", active, (B,), torch.bool)]
    for name, t, shape, dtype in wants:
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous of shape {shape}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _device_guard(device: torch.device):
    """No guard when `device` is already current (the usual case)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _launch(epilogue: int, A, X: torch.Tensor, out: torch.Tensor,
            hat=None, cur=None, last=None, p0=None, p1=None, p2=None,
            scal=None, inner=None, active=None, t: int = 0,
            plan: tuple | None = None) -> None:
    """One launch of csrc/spmm.cu on checked arguments.  `plan` (G, V,
    grid_x, n_slices) defaults to the cached plan of the shape, dtype and
    alignment; another plan serves only to measure the design."""
    lib = _library()
    B = X.shape[1]
    rows = (out, hat, cur, last, p0, p1, p2)
    if plan is None:
        align = X.data_ptr()
        for r in rows:
            if r is not None:
                align |= r.data_ptr()
        plan = _launch_plan(A.nrows, A.ncols, B, X.element_size(),
                            align % 16)

    def ptr(t_):
        return None if t_ is None else t_.data_ptr()

    with _device_guard(X.device):
        err = lib.hprlp_spmm(
            int(X.dtype == torch.float64), epilogue, A.nrows, B, *plan, t,
            A.indptr.data_ptr(), A.indices.data_ptr(), A.vals.data_ptr(),
            X.data_ptr(), *(ptr(r) for r in rows), ptr(scal), ptr(inner),
            ptr(active), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.hprlp_spmm_error_string(err).decode()
        raise RuntimeError(f"CSR SpMM launch failed (epilogue {epilogue}, "
                           f"B={B}, plan G, V, grid_x, n_slices = {plan}): "
                           f"{msg} ({err})")


def csr_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X on the card.  A: CsrMatrix-like (indptr, indices, vals,
    nrows, ncols, nnz); X: (ncols, B) row-major.  Raises on a bad argument
    or a refused launch."""
    check_spmm_args(A, X)
    # torch.empty's blocks are 512-byte aligned, as wide as any load.
    Y = torch.empty((A.nrows, X.shape[1]), dtype=X.dtype, device=X.device)
    _launch(STORE, A, X, Y)
    csr_spmm.launches += 1
    return Y


csr_spmm.launches = 0


def spmm_x_half(AT, y, x, last_x, c, l, u, sigma, inner, active, t: int):
    """One middle-iteration x-half on the card, fused into A^T y's row
    write: returns (x_new, x_hat), each (n, B), as x_half_plain computes
    them.  AT: A^T (n rows); y: (m, B); x, last_x, c, l, u: (n, B); sigma:
    (B,); inner: (B,) int32, the Halpern counters when t = 0; active: (B,)
    bool; t: the middle iteration's index.  Raises on a bad argument or a
    refused launch."""
    check_half_args(AT, y, {"x": x, "last_x": last_x, "c": c, "l": l,
                            "u": u}, sigma, inner, active)
    x_new, x_hat = torch.empty_like(x), torch.empty_like(x)
    _launch(X_HALF, AT, y, x_new, x_hat, x, last_x, c, l, u, sigma, inner,
            active, t)
    spmm_x_half.launches += 1
    return x_new, x_hat


spmm_x_half.launches = 0


def spmm_y_half(A, x_hat, y, last_y, AL, AU, lam_sigma, inner, active,
                t: int):
    """One middle-iteration y-half on the card, fused into A x_hat's row
    write: returns y_new (m, B), as y_half_plain computes it.  A: m rows;
    x_hat: (n, B); y, last_y, AL, AU: (m, B); lam_sigma: (B,); inner,
    active, t as for spmm_x_half.  Raises on a bad argument or a refused
    launch."""
    check_half_args(A, x_hat, {"y": y, "last_y": last_y, "AL": AL, "AU": AU},
                    lam_sigma, inner, active)
    y_new = torch.empty_like(y)
    _launch(Y_HALF, A, x_hat, y_new, None, y, last_y, AL, AU, None,
            lam_sigma, inner, active, t)
    spmm_y_half.launches += 1
    return y_new


spmm_y_half.launches = 0


def csr_spmm_rowwise(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X on the card by the previous design (csrc/
    spmm_rowwise.cu), for measurements: the solver runs csr_spmm.  Raises
    on a bad argument or a refused launch."""
    check_spmm_args(A, X)
    B = X.shape[1]
    G, V, n_slices = spmm_plan(B, X.element_size(), X.data_ptr())
    lib = _rowwise_library()
    Y = torch.empty((A.nrows, B), dtype=X.dtype, device=X.device)
    with _device_guard(X.device):
        err = lib.hprlp_csr_spmm(
            int(X.dtype == torch.float64), A.nrows, B, G, V, n_slices,
            A.indptr.data_ptr(), A.indices.data_ptr(), A.vals.data_ptr(),
            X.data_ptr(), Y.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.hprlp_spmm_error_string(err).decode()
        raise RuntimeError(f"CSR SpMM (row-wise) launch failed (B={B}, G={G},"
                           f" V={V}): {msg} ({err})")
    csr_spmm_rowwise.launches += 1
    return Y


csr_spmm_rowwise.launches = 0


def spmm_reference(A, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = A @ X (any device): scatter-add of the rows of
    vals[:, None] * X[indices]."""
    prod = A.vals[:, None] * X[A.indices.to(torch.int64)]
    return torch.zeros((A.nrows, X.shape[1]), dtype=X.dtype,
                       device=X.device).index_add_(0, row_of_entry(A), prod)
