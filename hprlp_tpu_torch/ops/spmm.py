"""SpMM, Y = A X for the batched solver: the hand-written Hopper kernels,
their launch plan and their plain versions.

`csr_spmm` launches `csrc/spmm.cu`'s solver design (slice-major grid under
an L2 budget, row blocks, a register cap) on a CsrMatrix and a
dense row-major X of shape (ncols, B), f32 or f64, any B >= 1;
`spmm_reference` is its contract in plain PyTorch.  `spmm_x_half` runs
the same kernel with the batched HPR middle iteration's x-half-update
fused into its row write.  `spmm_y_half` fuses the y-half into the same
product on the y-half's own kernel (`spmm_y_ring_kernel`: X's segments
gathered by cp.async into a shared-memory ring, the streamed rows fetched
under the gather; its plan is `ring_plan`), and `spmm_y_half_previous`
launches the previous y-half (the product kernel's epilogue, bitwise the
same), kept to be timed beside it: no solve launches it.  Their plain
versions are solver/batched.py::x_half_plain and y_half_plain.
`csr_spmm_rowwise` launches the previous product design
(`csrc/spmm_rowwise.cu`: row-major tasks), kept in its own library to be
timed beside the new one.  The JAX package
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
from typing import NamedTuple

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
# The y-half's ring kernel (csrc/spmm.cu): entries a commit group by value
# size (Ring<T>::kBatch; a lane's ring holds two batches).
RING_BATCH = {4: 3, 8: 4}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build(SOURCE))
    i, ptr = ctypes.c_int, ctypes.c_void_p
    lib.hprlp_spmm.argtypes = [i] * 9 + [ptr] * 15
    lib.hprlp_spmm.restype = i
    lib.hprlp_spmm_y_ring.argtypes = [i] * 8 + [ptr] * 13
    lib.hprlp_spmm_y_ring.restype = i
    lib.hprlp_spmm_ring_init.argtypes = []
    lib.hprlp_spmm_ring_init.restype = i
    lib.hprlp_spmm_error_string.argtypes = [i]
    lib.hprlp_spmm_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _ring_ready(device_index: int) -> None:
    """Set the ring kernel's shared-memory attributes on `device_index`:
    once a device, before any launch there, since they belong to that
    device's context."""
    lib = _library()
    with torch.cuda.device(device_index):
        err = lib.hprlp_spmm_ring_init()
    if err != 0:
        raise RuntimeError("the y-half's ring kernel could not be set up: "
                           f"{lib.hprlp_spmm_error_string(err).decode()} "
                           f"({err})")


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


class RingPlan(NamedTuple):
    """A launch of the y-half's ring kernel: G lanes a group and V columns
    a lane over n_slices column slices (spmm_plan's, so each slice's
    window of X stays within L2_BUDGET), a row a group, a grid of
    (grid_x, n_slices) blocks of BLOCK threads, and smem_bytes of dynamic
    shared memory a block."""
    G: int
    V: int
    n_slices: int
    grid_x: int
    smem_bytes: int


def ring_smem_bytes(V: int, itemsize: int) -> int:
    """csrc/spmm.cu::ring_smem_bytes: each thread's ring of two batches of
    slots of V values and a parked value each, and its row of the 4
    streamed operands."""
    return BLOCK * (2 * RING_BATCH[itemsize] * (V + 1) + 4 * V) * itemsize


@functools.lru_cache(maxsize=1024)
def ring_plan(nrows: int, ncols: int, B: int, itemsize: int,
              align: int) -> RingPlan:
    """The y-half's ring kernel's plan for one shape, dtype and alignment
    (the operands' addresses, ORed, modulo 16)."""
    G, V, n_slices = spmm_plan(B, itemsize, align, ncols)
    return RingPlan(G, V, n_slices, spmm_grid(nrows, G, n_slices)[0],
                    ring_smem_bytes(V, itemsize))


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


def _align(*tensors) -> int:
    """The OR of the tensors' addresses (None skipped) modulo 16: the
    widest vector load they all allow."""
    align = 0
    for t_ in tensors:
        if t_ is not None:
            align |= t_.data_ptr()
    return align % 16


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
        plan = _launch_plan(A.nrows, A.ncols, B, X.element_size(),
                            _align(X, *rows))

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


def _ring_launch(A, X: torch.Tensor, out, cur, last, p0, p1, scal, inner,
                 active, t: int, plan: RingPlan | None = None) -> None:
    """One launch of the y-half's ring kernel on checked arguments, on
    X's device.  `plan` defaults to ring_plan of the shape, dtype and
    alignment; another plan serves only to test the kernel's refusals."""
    lib = _library()
    B = X.shape[1]
    rows = (out, cur, last, p0, p1)
    if plan is None:
        plan = ring_plan(A.nrows, A.ncols, B, X.element_size(),
                         _align(X, *rows))
    with _device_guard(X.device):
        _ring_ready(torch.cuda.current_device())
        err = lib.hprlp_spmm_y_ring(
            int(X.dtype == torch.float64), A.nrows, B, plan.G, plan.V,
            plan.grid_x, plan.n_slices, t,
            A.indptr.data_ptr(), A.indices.data_ptr(), A.vals.data_ptr(),
            X.data_ptr(), *(r.data_ptr() for r in rows), scal.data_ptr(),
            inner.data_ptr(), active.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.hprlp_spmm_error_string(err).decode()
        raise RuntimeError(f"the y-half's ring kernel failed to launch "
                           f"(B={B}, plan {plan}): {msg} ({err})")


def spmm_y_half(A, x_hat, y, last_y, AL, AU, lam_sigma, inner, active,
                t: int):
    """One middle-iteration y-half on the card, fused into A x_hat's row
    write on the ring kernel: returns y_new (m, B), as y_half_plain
    computes it and bitwise spmm_y_half_previous's.  A: m rows; x_hat:
    (n, B); y, last_y, AL, AU: (m, B); lam_sigma: (B,); inner, active, t
    as for spmm_x_half.  Raises on a bad argument or a refused launch."""
    check_half_args(A, x_hat, {"y": y, "last_y": last_y, "AL": AL, "AU": AU},
                    lam_sigma, inner, active)
    y_new = torch.empty_like(y)
    _ring_launch(A, x_hat, y_new, y, last_y, AL, AU, lam_sigma, inner,
                 active, t)
    spmm_y_half.launches += 1
    return y_new


spmm_y_half.launches = 0


def spmm_y_half_previous(A, x_hat, y, last_y, AL, AU, lam_sigma, inner,
                         active, t: int):
    """spmm_y_half by the previous design (the product kernel's kYHalf
    epilogue: register gathers, operands read after them), for
    measurements and as the new kernel's bitwise yardstick: no solve
    launches it.  Arguments and result as for spmm_y_half."""
    check_half_args(A, x_hat, {"y": y, "last_y": last_y, "AL": AL, "AU": AU},
                    lam_sigma, inner, active)
    y_new = torch.empty_like(y)
    _launch(Y_HALF, A, x_hat, y_new, None, y, last_y, AL, AU, None,
            lam_sigma, inner, active, t)
    spmm_y_half_previous.launches += 1
    return y_new


spmm_y_half_previous.launches = 0


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
