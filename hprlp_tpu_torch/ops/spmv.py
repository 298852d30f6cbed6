"""CSR SpMV: the hand-written Hopper kernel, its build, and its plain version.

`csr_spmv` launches `csrc/spmv.cu` (row-parallel CSR, f32 or f64) on a
CUDA tensor; `spmv_reference` is the same contract in plain PyTorch.  The
kernel replaces the four Pallas TPU kernels of hprlp_tpu/ops/pallas_spmv.py
(lane_spmv, thin_spmv, lane_spmv_df64, thin_spmv_df64; see the notes at
the top of the CUDA source).

The library is compiled with nvcc on first use into `_build/` next to this
package (one file per source hash) and loaded with ctypes; nothing is built
or imported from a GPU toolchain when this module is imported.  `build`
takes any source of the package's `csrc/`, so the variant-study kernels
(ops/spmv_variants.py) build by the same rule.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_HERE, "csrc", "spmv.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_THREADS_PER_ROW = (2, 4, 8, 16, 32)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                           "kernels cannot be built")
    return path


def library_path(source: str = SOURCE) -> str:
    """Where `source` builds to: one file per source (and flags) hash."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR,
                        f"libhprlp_{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str = SOURCE, ptxas_log: list | None = None) -> str:
    """Compile `source` (a CUDA file with a plain C interface) into a
    shared library if it has not been built yet.  Returns the library
    path.  Raises if nvcc fails.  With a list as `ptxas_log`, nvcc also
    reports each kernel's registers and spills (-Xptxas -v) and its output
    is appended there."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS,
           *(("-Xptxas", "-v") if ptxas_log is not None else ()),
           "-o", tmp, source]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        if ptxas_log is not None:
            ptxas_log.append(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    ptr = ctypes.c_void_p
    for name in ("hprlp_csr_spmv_f32", "hprlp_csr_spmv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.hprlp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hprlp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def threads_per_row(nnz: int, nrows: int) -> int:
    """Smallest supported group width covering the mean row length."""
    mean = nnz / max(nrows, 1)
    for t in _THREADS_PER_ROW:
        if t >= mean:
            return t
    return _THREADS_PER_ROW[-1]


def check_csr_args(A, x: torch.Tensor) -> None:
    """The checks every CSR kernel wrapper makes before a launch."""
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got "
                         f"{x.device}")
    for name, t in (("indptr", A.indptr), ("indices", A.indices),
                    ("vals", A.vals)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if A.indptr.dtype != torch.int32 or A.indices.dtype != torch.int32:
        raise TypeError("indptr and indices must be int32")
    if A.vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported value dtype {A.vals.dtype}")
    if x.dtype != A.vals.dtype:
        raise TypeError(f"x is {x.dtype}, matrix values are {A.vals.dtype}")
    if x.shape != (A.ncols,) or not x.is_contiguous():
        raise ValueError(f"x must be contiguous of shape ({A.ncols},), got "
                         f"{tuple(x.shape)}")
    if A.indptr.shape != (A.nrows + 1,) or A.indices.shape != (A.nnz,) \
            or A.vals.shape != (A.nnz,):
        raise ValueError("CSR arrays do not match nrows/nnz")


def csr_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x on the card.  A: CsrMatrix-like (indptr, indices, vals,
    nrows, ncols, nnz).  Raises on a bad argument or a refused launch."""
    check_csr_args(A, x)
    lib = _library()
    y = torch.empty(A.nrows, dtype=x.dtype, device=x.device)
    fn = (lib.hprlp_csr_spmv_f32 if x.dtype == torch.float32
          else lib.hprlp_csr_spmv_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(A.nrows, threads_per_row(A.nnz, A.nrows),
                 A.indptr.data_ptr(), A.indices.data_ptr(), A.vals.data_ptr(),
                 x.data_ptr(), y.data_ptr(), stream)
    if err != 0:
        msg = lib.hprlp_cuda_error_string(err).decode()
        raise RuntimeError(f"CSR SpMV launch failed: {msg} ({err})")
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0


def row_of_entry(A) -> torch.Tensor:
    """Row index of every stored entry (int64, on A's device)."""
    counts = (A.indptr[1:] - A.indptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(A.nrows, device=A.indptr.device), counts,
        output_size=A.nnz)


def spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A @ x (any device): scatter-add of the products."""
    prod = A.vals * x[A.indices.to(torch.int64)]
    return torch.zeros(A.nrows, dtype=x.dtype, device=x.device).index_add_(
        0, row_of_entry(A), prod)
