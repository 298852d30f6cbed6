"""SpMM, Y = A X for the batched solver: the hand-written Hopper kernel,
its launch plan and its plain version.

`csr_spmm` launches `csrc/spmm.cu` on a CsrMatrix and a dense row-major
X of shape (ncols, B), f32 or f64, any B >= 1; `spmm_reference` is its
contract in plain PyTorch.  The JAX package has no Pallas kernel here: it
computes the product as an XLA gather einsum (hprlp_tpu/ops/sparse.py:
594-608).  The library builds with nvcc on first use, by ops/spmv.py's
rule, and loads with ctypes; nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .spmv import _HERE, build, check_csr_matrix, row_of_entry

SOURCE = os.path.join(_HERE, "csrc", "spmm.cu")
WARP = 32


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build(SOURCE))
    i, ptr = ctypes.c_int, ctypes.c_void_p
    lib.hprlp_csr_spmm.argtypes = [i] * 6 + [ptr] * 6
    lib.hprlp_csr_spmm.restype = i
    lib.hprlp_spmm_error_string.argtypes = [i]
    lib.hprlp_spmm_error_string.restype = ctypes.c_char_p
    return lib


def spmm_plan(B: int, itemsize: int, address: int) -> tuple[int, int, int]:
    """(G, V, n_slices) of the kernel's launch for B columns of `itemsize`
    bytes, X at `address`: V columns per lane, the widest load of at most
    16 bytes that B and the address allow; G lanes per (row, slice), the
    least power of two with G * V >= B, at most a warp; n_slices slices of
    G * V columns cover B."""
    V = 1
    for v in (4, 2):
        if v * itemsize <= 16 and B % v == 0 and address % (v * itemsize) == 0:
            V = v
            break
    G = 1
    while G < WARP and G * V < B:
        G *= 2
    return G, V, -(-B // (G * V))


def check_spmm_args(A, X: torch.Tensor) -> None:
    """The checks csr_spmm makes before a launch."""
    check_csr_matrix(A, X)
    if X.dim() != 2 or X.shape[0] != A.ncols or X.shape[1] < 1 \
            or not X.is_contiguous():
        raise ValueError(f"X must be contiguous of shape ({A.ncols}, B) with "
                         f"B >= 1, got {tuple(X.shape)}")


def csr_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X on the card.  A: CsrMatrix-like (indptr, indices, vals,
    nrows, ncols, nnz); X: (ncols, B) row-major.  Raises on a bad argument
    or a refused launch."""
    check_spmm_args(A, X)
    B = X.shape[1]
    G, V, n_slices = spmm_plan(B, X.element_size(), X.data_ptr())
    lib = _library()
    # torch.empty's blocks are 512-byte aligned, as wide as any load.
    Y = torch.empty((A.nrows, B), dtype=X.dtype, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.hprlp_csr_spmm(
            int(X.dtype == torch.float64), A.nrows, B, G, V, n_slices,
            A.indptr.data_ptr(), A.indices.data_ptr(), A.vals.data_ptr(),
            X.data_ptr(), Y.data_ptr(), stream)
    if err != 0:
        msg = lib.hprlp_spmm_error_string(err).decode()
        raise RuntimeError(f"CSR SpMM launch failed (B={B}, G={G}, V={V}): "
                           f"{msg} ({err})")
    csr_spmm.launches += 1
    return Y


csr_spmm.launches = 0


def spmm_reference(A, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = A @ X (any device): scatter-add of the rows of
    vals[:, None] * X[indices]."""
    prod = A.vals[:, None] * X[A.indices.to(torch.int64)]
    return torch.zeros((A.nrows, X.shape[1]), dtype=X.dtype,
                       device=X.device).index_add_(0, row_of_entry(A), prod)
