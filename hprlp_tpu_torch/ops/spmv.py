"""SpMV: the hand-written Hopper kernels, their build, and their plain
versions.

`tiled_spmv` launches `csrc/spmv_tiled.cu` (x staged in shared memory by
column strips, f32 or f64) on the column-strip tiles of ops/tiles.py,
whose plain version is `tiles.tiled_spmv_reference`; it is the main
path's SpMV and replaces the four Pallas TPU kernels of
hprlp_tpu/ops/pallas_spmv.py (lane_spmv, thin_spmv, lane_spmv_df64,
thin_spmv_df64; see the notes at the top of the CUDA source).
`csr_spmv` launches the previous design, `csrc/spmv.cu` (row-parallel
CSR), on a CsrMatrix without tiles; `spmv_reference` is its contract in
plain PyTorch.

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

from .tiles import CLUSTER, WARPS, vec_width

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


def check_csr_matrix(A, x: torch.Tensor) -> None:
    """The checks every CSR kernel wrapper makes of A and of the device and
    dtype of its dense operand x before a launch."""
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
    if A.indptr.shape != (A.nrows + 1,) or A.indices.shape != (A.nnz,) \
            or A.vals.shape != (A.nnz,):
        raise ValueError("CSR arrays do not match nrows/nnz")


def check_csr_args(A, x: torch.Tensor) -> None:
    """The checks the CSR SpMV wrapper makes before a launch."""
    check_csr_matrix(A, x)
    if x.shape != (A.ncols,) or not x.is_contiguous():
        raise ValueError(f"x must be contiguous of shape ({A.ncols},), got "
                         f"{tuple(x.shape)}")


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


TILED_SOURCE = os.path.join(_HERE, "csrc", "spmv_tiled.cu")
# The tiled kernel's stages (csrc/spmv_tiled.cu), by the cluster size they
# pass to it: x gathered from global memory, x strips staged per block, x
# strips multicast to a cluster of 2, 4 or 8 blocks.  Every stage computes
# the same y; the main path runs MAIN_STAGE.
TILED_STAGES = {"global_x": 0, "block_x": 1, "cluster2_x": 2,
                "cluster4_x": 4, "cluster8_x": 8}
MAIN_STAGE = "block_x"


@functools.cache
def _tiled_library(device_index: int) -> ctypes.CDLL:
    """Build and load the tiled kernel, and raise its shared-memory limit
    on `device_index` (once, before any launch or graph capture)."""
    lib = ctypes.CDLL(build(TILED_SOURCE))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.hprlp_tiled_spmv.argtypes = [i] * 10 + [ptr] * 8
    lib.hprlp_tiled_spmv.restype = i
    lib.hprlp_tiled_max_active_clusters.argtypes = [i, i, i]
    lib.hprlp_tiled_max_active_clusters.restype = i
    lib.hprlp_tiled_error_string.argtypes = [i]
    lib.hprlp_tiled_error_string.restype = ctypes.c_char_p
    with torch.cuda.device(device_index):
        err = lib.hprlp_tiled_init()
    if err != 0:
        msg = lib.hprlp_tiled_error_string(err).decode()
        raise RuntimeError(f"tiled SpMV: raising the shared-memory limit "
                           f"failed: {msg} ({err})")
    return lib


def check_tiled_args(T, x: torch.Tensor) -> None:
    """The checks the tiled kernel's wrapper makes before a launch."""
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got "
                         f"{x.device}")
    check_tiled_layout(T, x)


def check_tiled_layout(T, x: torch.Tensor) -> None:
    """Device-independent part of check_tiled_args: types, shapes,
    contiguity and the 16-byte alignment the kernel's loads need."""
    for name, t, dtype in (("vals", T.vals, T.vals.dtype),
                           ("keys", T.keys, torch.int32),
                           ("runs", T.runs, torch.int32),
                           ("row_start", T.row_start, torch.int32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if T.vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported value dtype {T.vals.dtype}")
    if x.dtype != T.vals.dtype:
        raise TypeError(f"x is {x.dtype}, matrix values are {T.vals.dtype}")
    if x.shape != (T.ncols,) or not x.is_contiguous():
        raise ValueError(f"x must be contiguous of shape ({T.ncols},), got "
                         f"{tuple(x.shape)}")
    if T.runs.shape != (T.n_blocks * WARPS * T.group_strips + 1,) \
            or T.row_start.shape != (T.n_chunks + 1,) \
            or T.keys.shape != T.vals.shape:
        raise ValueError("tile arrays do not match the tiles' shape")
    # cp.async.bulk copies 16-byte multiples between 16-byte aligned
    # addresses; a strip starts at x + s * W, and each lane loads 16 bytes.
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for the bulk copies of "
                         "its strips (a view at an odd offset is not)")
    if T.strip_width % 32:
        raise ValueError(f"strip width {T.strip_width} is not a multiple "
                         f"of 32")
    if T.vals.data_ptr() % 16 or T.keys.data_ptr() % 16 \
            or T.vals.shape[0] % vec_width(T.vals.dtype):
        raise ValueError("tile values and keys must be 16-byte aligned and "
                         "padded to whole 16-byte loads")
    if T.n_chunks % CLUSTER:
        raise ValueError(f"{T.n_chunks} row chunks is not a multiple of "
                         f"the cluster size {CLUSTER}")


def tiled_spmv(T, x: torch.Tensor, stage: str = MAIN_STAGE) -> torch.Tensor:
    """y = A @ x on the card, on A's column-strip tiles (ops/tiles.py).
    `stage` picks a measurement variant (TILED_STAGES); all give the same
    y.  Raises on a bad argument or a refused launch."""
    check_tiled_args(T, x)
    if T.nnz == 0:  # nothing to launch (an LP with no constraints)
        return torch.zeros(T.nrows, dtype=x.dtype, device=x.device)
    lib = _tiled_library(x.device.index if x.device.index is not None
                         else torch.cuda.current_device())
    y = torch.empty(T.nrows, dtype=x.dtype, device=x.device)
    # Each strip group's partial y, summed in group order by a second pass.
    part = (torch.empty(T.n_groups * T.nrows, dtype=x.dtype, device=x.device)
            if T.n_groups > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hprlp_tiled_spmv(
            int(x.dtype == torch.float64), TILED_STAGES[stage], T.nrows,
            T.ncols, T.strip_width, T.n_strips, T.n_groups, T.group_strips,
            T.n_chunks, T.max_block_rows, T.vals.data_ptr(),
            T.keys.data_ptr(), T.runs.data_ptr(), T.row_start.data_ptr(),
            x.data_ptr(), None if part is None else part.data_ptr(),
            y.data_ptr(), stream)
    if err != 0:
        msg = lib.hprlp_tiled_error_string(err).decode()
        raise RuntimeError(f"tiled SpMV launch failed ({stage}, "
                           f"{T.n_blocks} blocks, {T.smem_bytes} B shared "
                           f"memory): {msg} ({err})")
    tiled_spmv.launches += 1
    return y


tiled_spmv.launches = 0


def max_active_clusters(T, stage: str = MAIN_STAGE) -> int:
    """How many clusters of `stage` fit on the card at once at T's shared
    memory (cudaOccupancyMaxActiveClusters)."""
    lib = _tiled_library(torch.cuda.current_device())
    return lib.hprlp_tiled_max_active_clusters(
        int(T.vals.dtype == torch.float64), TILED_STAGES[stage],
        T.smem_bytes)


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
