"""SpMV: the hand-written Hopper kernels, their build, and their plain
versions.

`tiled_spmv` launches `csrc/spmv_tiled.cu` (x staged in shared memory by
column strips, f32 or f64) on the column-strip tiles of ops/tiles.py,
whose plain version is `tiles.tiled_spmv_reference`; it is the main
path's SpMV and replaces the four Pallas TPU kernels of
hprlp_tpu/ops/pallas_spmv.py (lane_spmv, thin_spmv, lane_spmv_df64,
thin_spmv_df64; see the notes at the top of the CUDA source).  Its main
stage launches the G strip-group blocks of each row chunk as one
thread-block cluster, which sums their partials through distributed
shared memory: one launch at any G; `cluster_slots` is the card's count
of such clusters resident at once, which build_tiles takes on the card.
`tiled_x_half` and `tiled_y_half` run the same kernel with the single-LP
middle iteration's x- or y-half fused into its row write, and
`tiled_half_epilogue` runs that half alone on a given product, as a
column-sharded mesh does after its all-reduce (their plain versions:
solver/chunk.py::x_half_plain, y_half_plain, x_update, y_update).
`csr_spmv` launches `csrc/spmv_csr.cu` (row blocks, 16-byte vector loads,
sums in shared memory) on a CsrMatrix that carries its row-block plan
(`row_blocks`): the "gather" backend; `spmv_x_half` and `spmv_y_half` run
the same kernel with the single-LP middle iteration's x- or y-half fused
into its row write (their plain versions: solver/chunk.py::x_half_plain,
y_half_plain).  `csr_spmv_plain` computes the kernel's bits in plain
PyTorch on the plan, and `spmv_reference` is the contract (any order).
`csr_spmv_rowgroup` launches the previous design, `csrc/spmv.cu` (a group of
threads per row), kept to be timed: no solve launches it.  `csr_study`
launches the same kernel's variant-study instantiations (ops/
spmv_variants.py's ablate, multi_acc and flush families), and
`plan_row_sums` gives the per-row sums of most of them in plain PyTorch.

Each library is compiled with nvcc on first use into `_build/` next to
this package (one file per source hash) and loaded with ctypes; nothing is
built or imported from a GPU toolchain when this module is imported.
`build` takes any source of the package's `csrc/`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import types

import torch

from .tiles import CLUSTER, MAX_GROUPS, SMEM_BYTES, WARPS, vec_width

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_HERE, "csrc", "spmv_csr.cu")
ROWGROUP_SOURCE = os.path.join(_HERE, "csrc", "spmv.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_THREADS_PER_ROW = (2, 4, 8, 16, 32)
CSR_BLOCK = 256  # threads per block (csrc/spmv_csr.cu kBlock)
CSR_CAP_BYTES = 8192  # values per window of a row block (kCap<T>), in bytes
CSR_VEC = 4  # entries per vector load (csrc/spmv_csr.cu kVec)
# csrc/spmv_csr.cu's epilogues: y = A x, a fused half, or one of the
# ablate or flush study's measurements.
(STORE, X_HALF, Y_HALF, NO_GATHER, DMA_ONLY, ONE_GATHER, NO_FLUSH,
 RUN_MERGE, MERGE_ALL) = range(9)


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
    """Where `source` builds to: one file per hash of the source, the
    headers of csrc/ it includes ("...") and the flags."""
    with open(source, "rb") as f:
        text = f.read()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    for name in re.findall(rb'#include "([^"]+)"', text):
        with open(os.path.join(os.path.dirname(source), name.decode()),
                  "rb") as f:
            digest.update(f.read())
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
    i, ptr = ctypes.c_int, ctypes.c_void_p
    lib.hprlp_csr_spmv.argtypes = [i, i, i, i, ctypes.c_longlong, i, i] \
        + [ptr] * 16
    lib.hprlp_csr_spmv.restype = i
    lib.hprlp_csr_study.argtypes = [i, i, i, i, ctypes.c_longlong, i] \
        + [ptr] * 8
    lib.hprlp_csr_study.restype = i
    lib.hprlp_csr_error_string.argtypes = [i]
    lib.hprlp_csr_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _rowgroup_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build(ROWGROUP_SOURCE))
    ptr = ctypes.c_void_p
    for name in ("hprlp_csr_spmv_f32", "hprlp_csr_spmv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.hprlp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hprlp_cuda_error_string.restype = ctypes.c_char_p
    return lib


@dataclasses.dataclass(frozen=True)
class RowBlocks:
    """The CSR kernel's plan (csrc/spmv_csr.cu): block b owns rows
    row0[b] .. row0[b + 1] - 1 and entries ent0[b] .. ent0[b + 1] - 1.
    It depends on indptr only, so new values keep it."""

    row0: torch.Tensor  # (n_blocks + 1,) int32, ends with nrows
    ent0: torch.Tensor  # (n_blocks + 1,) int32, indptr[row0]
    cap: int            # the window it was cut by (row_blocks)

    @property
    def n_blocks(self) -> int:
        return int(self.row0.shape[0]) - 1

    @property
    def nbytes(self) -> int:
        return (self.row0.numel() + self.ent0.numel()) * 4


def csr_cap(dtype: torch.dtype) -> int:
    """Entries per window of a row block in `dtype` (csrc/spmv_csr.cu
    kCap<T>): 2048 in f32, 1024 in f64."""
    return CSR_CAP_BYTES // torch.empty((), dtype=dtype).element_size()


def row_blocks(A, cap: int | None = None, max_rows: int = CSR_BLOCK
               ) -> RowBlocks:
    """The row-block plan of CSR matrix A, on A's device (torch ops, no
    loop over rows): a block starts at every row whose first entry lies in
    another window of `cap` entries than its predecessor's, at each row
    longer than `cap` and the row after it, and every `max_rows` rows
    within the rest.  So a block of short rows holds fewer than 2 * cap
    entries and at most max_rows rows, and a long row is a block alone.
    `cap` defaults to the kernel's, csr_cap of A's value type."""
    cap = csr_cap(A.vals.dtype) if cap is None else int(cap)
    indptr = A.indptr.to(torch.int64)
    n = A.nrows
    dev = indptr.device
    if n == 0:
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        return RowBlocks(row0=zero, ent0=zero.clone(), cap=cap)
    start = indptr[:-1]
    long = indptr[1:] - start > cap
    cut = torch.ones(n, dtype=torch.bool, device=dev)
    cut[1:] = (start[1:] // cap != start[:-1] // cap) | long[1:] | long[:-1]
    r = torch.arange(n, device=dev)
    first = torch.cummax(torch.where(cut, r, 0), 0).values
    cut |= (r - first) % max_rows == 0
    row0 = torch.cat([torch.nonzero(cut).flatten(),
                      torch.full((1,), n, dtype=torch.int64, device=dev)])
    return RowBlocks(row0=row0.to(torch.int32),
                     ent0=indptr[row0].to(torch.int32), cap=cap)


def threads_per_row(nnz: int, nrows: int) -> int:
    """Smallest supported group width covering the mean row length."""
    mean = nnz / max(nrows, 1)
    for t in _THREADS_PER_ROW:
        if t >= mean:
            return t
    return _THREADS_PER_ROW[-1]


def _check_cuda(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got "
                         f"{x.device}")


def check_csr_matrix(A, x: torch.Tensor) -> None:
    """The checks every CSR kernel wrapper makes of A and of the device and
    dtype of its dense operand x before a launch."""
    _check_cuda(x)
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


def check_blocks(A, x: torch.Tensor) -> None:
    """The checks of the row-block kernel's wrappers beyond
    check_csr_args' (device-independent: the tests call it on the CPU):
    the plan's shape and device, and 16-byte aligned entry arrays."""
    P = A.blocks
    if P is None:
        raise ValueError("A carries no row-block plan: attach "
                         "row_blocks(A) (ops/sparse.py::with_spmv_backend "
                         "\"gather\" does)")
    for name, t in (("row0", P.row0), ("ent0", P.ent0)):
        if t.device != x.device or t.dtype != torch.int32 \
                or not t.is_contiguous() or t.shape != (P.n_blocks + 1,):
            raise ValueError(f"the plan's {name} must be contiguous int32 "
                             f"on {x.device}")
    if P.n_blocks < 0 or (A.nrows > 0 and P.n_blocks == 0):
        raise ValueError("the plan covers no rows")
    if P.cap != csr_cap(x.dtype):
        raise ValueError(f"the plan was cut by windows of {P.cap} entries, "
                         f"the {x.dtype} kernel's are {csr_cap(x.dtype)}")
    if A.vals.data_ptr() % 16 or A.indices.data_ptr() % 16:
        raise ValueError("vals and indices must be 16-byte aligned for the "
                         "kernel's vector loads (a view at an odd offset is "
                         "not)")


def _csr_launch(epilogue: int, A, x: torch.Tensor, out: torch.Tensor,
                hat=None, cur=None, last=None, p0=None, p1=None, p2=None,
                scal=None, inner=None, t: int = 0) -> None:
    """One launch of csrc/spmv_csr.cu on checked arguments."""
    lib = _library()

    def ptr(v):
        return None if v is None else v.data_ptr()

    P = A.blocks
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hprlp_csr_spmv(
            int(x.dtype == torch.float64), epilogue, A.nrows, A.ncols, A.nnz,
            P.n_blocks, t, P.row0.data_ptr(), P.ent0.data_ptr(),
            A.indptr.data_ptr(), A.indices.data_ptr(), A.vals.data_ptr(),
            x.data_ptr(), out.data_ptr(), ptr(hat), ptr(cur), ptr(last),
            ptr(p0), ptr(p1), ptr(p2), ptr(scal), ptr(inner), stream)
    _raise_on(lib, err, f"epilogue {epilogue}, {P.n_blocks} blocks")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.hprlp_csr_error_string(err).decode()
        raise RuntimeError(f"CSR SpMV launch failed ({what}): {msg} ({err})")


def csr_study(variant: int, n_acc: int, A, x: torch.Tensor) -> torch.Tensor:
    """y of one variant-study instantiation of csrc/spmv_csr.cu (f32) on
    A's row-block plan: `variant` an epilogue (STORE, NO_GATHER, DMA_ONLY,
    ONE_GATHER, NO_FLUSH, RUN_MERGE, MERGE_ALL) with n_acc 1, or STORE
    with n_acc 1, 2 or 4.
    Checks A, x and the plan as csr_spmv does; f32 only.  Uncounted: the
    study wrappers of ops/spmv_variants.py count their own launches.
    Raises on a bad argument or a refused launch."""
    check_csr_args(A, x)
    if x.dtype != torch.float32:
        raise TypeError(f"the variant studies are f32 only, got {x.dtype}")
    check_blocks(A, x)
    # merge_all adds into y with atomics; every other variant stores it.
    y = (torch.zeros if variant == MERGE_ALL else torch.empty)(
        A.nrows, dtype=x.dtype, device=x.device)
    lib = _library()
    P = A.blocks
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hprlp_csr_study(
            variant, n_acc, A.nrows, A.ncols, A.nnz, P.n_blocks,
            P.row0.data_ptr(), P.ent0.data_ptr(), A.indptr.data_ptr(),
            A.indices.data_ptr(), A.vals.data_ptr(), x.data_ptr(),
            y.data_ptr(), stream)
    _raise_on(lib, err, f"study variant {variant}, n_acc {n_acc}, "
                        f"{P.n_blocks} blocks")
    return y


def csr_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x on the card, on A's row-block plan (A.blocks).  A:
    CsrMatrix-like (indptr, indices, vals, nrows, ncols, nnz, blocks).
    Raises on a bad argument or a refused launch."""
    check_csr_args(A, x)
    check_blocks(A, x)
    y = torch.empty(A.nrows, dtype=x.dtype, device=x.device)
    _csr_launch(STORE, A, x, y)
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0


def csr_spmv_no_gather(A, x: torch.Tensor) -> torch.Tensor:
    """The CSR kernel with x read at each entry's index (masked to x's
    length) in place of its column: the same stream, sums and store, no
    random gather.  A measurement of what the gather costs (the ablation
    of ops/spmv_variants.py's no_gather, asked of this design); its y is
    not A x, and no solve launches it.  Uncounted."""
    check_csr_args(A, x)
    check_blocks(A, x)
    y = torch.empty(A.nrows, dtype=x.dtype, device=x.device)
    _csr_launch(NO_GATHER, A, x, y)
    return y


def check_half_operands(nrows: int, v: torch.Tensor, rows: dict,
                        scal: torch.Tensor, inner: torch.Tensor) -> None:
    """The checks of a fused half's own operands (device-independent): each
    of `rows` (name -> tensor) contiguous (nrows,) of v's dtype and device;
    scal 0-dim of that dtype and inner 0-dim int32 on that device."""
    wants = [(name, t, (nrows,), v.dtype) for name, t in rows.items()]
    wants += [("scal", scal, (), v.dtype), ("inner", inner, (), torch.int32)]
    for name, t, shape, dtype in wants:
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, the operand on "
                             f"{v.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous of shape {shape}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def check_half_args(A, v: torch.Tensor, rows: dict, scal: torch.Tensor,
                    inner: torch.Tensor) -> None:
    """The checks the fused halves make before a launch: A and its gathered
    operand v as for csr_spmv, and check_half_operands over A's rows."""
    check_csr_args(A, v)
    check_half_operands(A.nrows, v, rows, scal, inner)
    check_blocks(A, v)


def spmv_x_half(AT, y, x, last_x, c, l, u, sigma, inner, t: int):
    """One single-LP middle-iteration x-half on the card, fused into A^T
    y's row write: returns (x_new, x_hat), as solver/chunk.py::
    x_half_plain computes them.  AT: A^T (n rows) with its plan; y: (m,);
    x, last_x, c, l, u: (n,); sigma: 0-dim; inner: 0-dim int32, the
    Halpern counter at the first middle iteration; t: this iteration's
    index.  Raises on a bad argument or a refused launch."""
    check_half_args(AT, y, {"x": x, "last_x": last_x, "c": c, "l": l,
                            "u": u}, sigma, inner)
    x_new, x_hat = torch.empty_like(x), torch.empty_like(x)
    _csr_launch(X_HALF, AT, y, x_new, x_hat, x, last_x, c, l, u, sigma,
                inner, t)
    spmv_x_half.launches += 1
    return x_new, x_hat


spmv_x_half.launches = 0


def spmv_y_half(A, x_hat, y, last_y, AL, AU, lam_sigma, inner, t: int):
    """One single-LP middle-iteration y-half on the card, fused into A
    x_hat's row write: returns y_new, as solver/chunk.py::y_half_plain
    computes it.  A: m rows with its plan; x_hat: (n,); y, last_y, AL, AU:
    (m,); lam_sigma: 0-dim; inner, t as for spmv_x_half.  Raises on a bad
    argument or a refused launch."""
    check_half_args(A, x_hat, {"y": y, "last_y": last_y, "AL": AL,
                               "AU": AU}, lam_sigma, inner)
    y_new = torch.empty_like(y)
    _csr_launch(Y_HALF, A, x_hat, y_new, None, y, last_y, AL, AU, None,
                lam_sigma, inner, t)
    spmv_y_half.launches += 1
    return y_new


spmv_y_half.launches = 0


def csr_spmv_rowgroup(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x on the card by the previous design (csrc/spmv.cu: a group of
    threads_per_row threads per row, shuffle sums), for measurements: no
    solve launches it.  Raises on a bad argument or a refused launch."""
    check_csr_args(A, x)
    lib = _rowgroup_library()
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
        raise RuntimeError(f"CSR SpMV (row groups) launch failed: {msg} "
                           f"({err})")
    csr_spmv_rowgroup.launches += 1
    return y


csr_spmv_rowgroup.launches = 0


TILED_SOURCE = os.path.join(_HERE, "csrc", "spmv_tiled.cu")
# The tiled kernel's stages (csrc/spmv_tiled.cu), by the code they pass to
# it: the G strip groups of each row chunk as one thread-block cluster that
# sums its partials through distributed shared memory (-1, the main
# stage); x gathered from global memory (0); x strips staged per block
# (1, block_x, the previous design: partials through HBM and a group-sum
# pass at G > 1); x strips multicast to a cluster of 2, 4 or 8 blocks.
# Every stage computes the same y, and the main stage and block_x the same
# bits; the main path runs MAIN_STAGE.
TILED_STAGES = {"group_cluster": -1, "global_x": 0, "block_x": 1,
                "cluster2_x": 2, "cluster4_x": 4, "cluster8_x": 8}
MAIN_STAGE = "group_cluster"
# The stages a fused half runs on: the main stage and the previous design.
HALF_STAGES = (MAIN_STAGE, "block_x")


@functools.cache
def _tiled_library(device_index: int) -> ctypes.CDLL:
    """Build and load the tiled kernel, and raise its shared-memory limit
    on `device_index` (once, before any launch or graph capture)."""
    lib = ctypes.CDLL(build(TILED_SOURCE))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.hprlp_tiled_spmv.argtypes = [i] * 11 + [ptr] * 8
    lib.hprlp_tiled_spmv.restype = i
    lib.hprlp_tiled_half.argtypes = [i] * 12 + [ptr] * 15 + [i, ptr]
    lib.hprlp_tiled_half.restype = i
    lib.hprlp_tiled_half_epilogue.argtypes = [i] * 4 + [ptr] * 10 + [i, ptr]
    lib.hprlp_tiled_half_epilogue.restype = i
    lib.hprlp_tiled_epilogue_info.argtypes = [i, i, ptr]
    lib.hprlp_tiled_epilogue_info.restype = i
    lib.hprlp_tiled_empty_launch.argtypes = [i, i, ptr]
    lib.hprlp_tiled_empty_launch.restype = i
    lib.hprlp_tiled_segsum.argtypes = [i] * 9 + [ptr] * 11
    lib.hprlp_tiled_segsum.restype = i
    lib.hprlp_tiled_max_active_clusters.argtypes = [i, i, i, i]
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
    _check_cuda(x)
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


def _index(device) -> int:
    """A CUDA device's index (the current device's for a bare "cuda")."""
    device = torch.device(device)
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _tiled_lib(x: torch.Tensor) -> ctypes.CDLL:
    return _tiled_library(_index(x.device))


def _tile_args(T, x: torch.Tensor, part) -> tuple:
    """The tile arguments of hprlp_tiled_spmv and hprlp_tiled_half, from
    nrows to x and the partials."""
    return (T.nrows, T.ncols, T.strip_width, T.n_strips, T.n_groups,
            T.group_strips, T.n_chunks, T.live_chunks, T.max_block_rows,
            T.vals.data_ptr(), T.keys.data_ptr(), T.runs.data_ptr(),
            T.row_start.data_ptr(),
            x.data_ptr(), None if part is None else part.data_ptr())


def _partials(T, x: torch.Tensor, stage: str):
    """Each strip group's partial y (G * nrows), summed in group order by
    group_sum_kernel, where the tiles have G > 1 groups and the stage is
    not the main one (whose clusters sum them in shared memory); else
    None.  The launch that takes them counts the group-sum pass."""
    if T.n_groups == 1 or stage == MAIN_STAGE:
        return None
    return torch.empty(T.n_groups * T.nrows, dtype=x.dtype, device=x.device)


# csrc/spmv_tiled.cu's group_sum_kernel, the second pass of every stage but
# the main one over G > 1 strip groups (the previous design, the multicast
# stages, the segsum study), launched inside their C entry points: each
# wrapper adds one here after a launch that took partials.  No solve
# launches it.
group_sum_kernel = types.SimpleNamespace(launches=0)
# The fused halves' launches on block_x, the previous design, apart from
# tiled_x_half's and tiled_y_half's counts, which take every stage: no
# solve launches them.
tiled_x_half_block_x = types.SimpleNamespace(launches=0)
tiled_y_half_block_x = types.SimpleNamespace(launches=0)
BLOCK_X_HALVES = {"x": tiled_x_half_block_x, "y": tiled_y_half_block_x}


def _launch_text(stage: str, T) -> str:
    return (f"{stage}, G {T.n_groups} x {T.n_chunks} chunks, "
            f"{T.smem_bytes} B shared memory")


def _raise_tiled(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.hprlp_tiled_error_string(err).decode()
        raise RuntimeError(f"tiled SpMV launch failed ({what}): {msg} "
                           f"({err})")


def tiled_spmv(T, x: torch.Tensor, stage: str = MAIN_STAGE) -> torch.Tensor:
    """y = A @ x on the card, on A's column-strip tiles (ops/tiles.py).
    `stage` picks a measurement variant (TILED_STAGES); all give the same
    y.  Raises on a bad argument or a refused launch."""
    check_tiled_args(T, x)
    if T.nnz == 0:  # nothing to launch (an LP with no constraints)
        return torch.zeros(T.nrows, dtype=x.dtype, device=x.device)
    lib = _tiled_lib(x)
    y = torch.empty(T.nrows, dtype=x.dtype, device=x.device)
    part = _partials(T, x, stage)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hprlp_tiled_spmv(
            int(x.dtype == torch.float64), TILED_STAGES[stage],
            *_tile_args(T, x, part), y.data_ptr(), stream)
    _raise_tiled(lib, err, _launch_text(stage, T))
    tiled_spmv.launches += 1
    group_sum_kernel.launches += part is not None
    return y


tiled_spmv.launches = 0

# The operands of each half besides its gathered operand, by the names the
# checks report, in csrc/spmv_tiled.cu's order (cur, last, p0, p1, p2), and
# its epilogue there (the numbers of csrc/spmv_csr.cu's).
HALF_ROWS = {"x": ("x", "last_x", "c", "l", "u"),
             "y": ("y", "last_y", "AL", "AU")}
HALF_EPILOGUES = {"x": X_HALF, "y": Y_HALF}


def _named_rows(half: str, rows) -> dict:
    names = HALF_ROWS[half]
    if len(rows) != len(names):
        raise ValueError(f"the {half}-half takes {len(names)} row operands "
                         f"({', '.join(names)}), got {len(rows)}")
    return dict(zip(names, rows))


def check_tiled_half_layout(T, v: torch.Tensor, half: str, rows,
                            scal: torch.Tensor, inner: torch.Tensor) -> None:
    """Device-independent checks of a fused half on the tiles: T and its
    gathered operand v as check_tiled_layout makes them, and `rows` (the
    tensors named HALF_ROWS[half], in that order) with scal and inner as
    check_half_operands makes them over T's rows."""
    check_tiled_layout(T, v)
    check_half_operands(T.nrows, v, _named_rows(half, rows), scal, inner)


def _half_out(half: str, rows):
    """The outputs of a half: (x_new, x_hat) or (y_new,), new tensors, so
    no output aliases an operand (a captured graph replays it as run)."""
    return tuple(torch.empty_like(rows[0]) for _ in range(
        2 if half == "x" else 1))


def _ptrs(out, rows, scal, inner) -> tuple:
    """out, hat, cur, last, p0, p1, p2, scal and inner as the C entries take
    them (None where a half has none)."""
    def ptr(v):
        return None if v is None else v.data_ptr()

    out, hat = (out + (None,))[:2]
    rows = tuple(rows) + (None,) * (5 - len(rows))
    return tuple(ptr(v) for v in (out, hat, *rows, scal, inner))


def _tiled_half(half: str, T, v: torch.Tensor, rows, scal, inner, t: int,
                stage: str):
    """One fused half on the tiles on `stage` (HALF_STAGES): checked,
    launched, its outputs."""
    if stage not in HALF_STAGES:
        raise ValueError(f"a fused half runs on {HALF_STAGES}, not {stage!r}")
    _check_cuda(v)
    check_tiled_half_layout(T, v, half, rows, scal, inner)
    out = _half_out(half, rows)
    if T.nnz == 0:  # no entries: every row's sum is +0
        _epilogue_launch(half, torch.zeros(T.nrows, dtype=v.dtype,
                                           device=v.device), out, rows,
                         scal, inner, t)
        return out
    lib = _tiled_lib(v)
    part = _partials(T, v, stage)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.hprlp_tiled_half(
            int(v.dtype == torch.float64), HALF_EPILOGUES[half],
            TILED_STAGES[stage], *_tile_args(T, v, part),
            *_ptrs(out, rows, scal, inner), t, stream)
    _raise_tiled(lib, err, f"{half}-half, " + _launch_text(stage, T))
    group_sum_kernel.launches += part is not None
    if stage == "block_x":
        BLOCK_X_HALVES[half].launches += 1
    return out


def tiled_x_half(T, y, x, last_x, c, l, u, sigma, inner, t: int,
                 stage: str = MAIN_STAGE):
    """One single-LP middle-iteration x-half on the card, fused into A^T
    y's row write on A^T's tiles T: returns (x_new, x_hat), as solver/
    chunk.py::x_half_plain computes them after tiled_spmv.  y: (m,); x,
    last_x, c, l, u: (n,); sigma: 0-dim; inner: 0-dim int32, the Halpern
    counter at the first middle iteration; t: this iteration's index;
    stage: one of HALF_STAGES (block_x for measurements).  One launch at
    any G on the main stage.  Raises on a bad argument or a refused
    launch."""
    out = _tiled_half("x", T, y, (x, last_x, c, l, u), sigma, inner, t,
                      stage)
    tiled_x_half.launches += 1
    return out


tiled_x_half.launches = 0


def tiled_y_half(T, x_hat, y, last_y, AL, AU, lam_sigma, inner, t: int,
                 stage: str = MAIN_STAGE):
    """One single-LP middle-iteration y-half on the card, fused into A
    x_hat's row write on A's tiles T: returns y_new, as solver/chunk.py::
    y_half_plain computes it after tiled_spmv.  x_hat: (n,); y, last_y,
    AL, AU: (m,); lam_sigma: 0-dim; inner, t, stage as for tiled_x_half.
    Raises on a bad argument or a refused launch."""
    out = _tiled_half("y", T, x_hat, (y, last_y, AL, AU), lam_sigma, inner,
                      t, stage)[0]
    tiled_y_half.launches += 1
    return out


tiled_y_half.launches = 0


EPI_THREADS = 256  # csrc/spmv_tiled.cu kEpiThreads


@dataclasses.dataclass(frozen=True)
class EpiloguePlan:
    """How half_epilogue_kernel covers its rows: `grid` blocks of
    `threads`, each thread one row a pass over `passes` passes."""
    threads: int
    grid: int
    passes: int


def epilogue_plan(n: int, sms: int, blocks_per_sm: int) -> EpiloguePlan:
    """The mesh's epilogue over n rows: one row a thread, the grid sized to
    the rows and capped at one wave (sms x blocks_per_sm resident blocks),
    beyond which threads stride.  Pure: the card's figures come in as
    arguments."""
    if n < 0 or sms <= 0:
        raise ValueError(f"no epilogue plan for {n} rows on {sms} SMs")
    if blocks_per_sm <= 0:
        raise RuntimeError("no block of the epilogue fits an SM")
    grid = max(1, min(-(-n // EPI_THREADS), sms * blocks_per_sm))
    return EpiloguePlan(EPI_THREADS, grid, -(-n // (EPI_THREADS * grid)))


@functools.cache
def _epilogue_info(device_index: int, f64: int, half: str) -> tuple:
    lib = _tiled_library(device_index)
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        err = lib.hprlp_tiled_epilogue_info(f64, HALF_EPILOGUES[half], out)
    _raise_tiled(lib, err, f"{half}-half epilogue, attributes")
    return out[0], out[1]


def epilogue_kernel_info(device, dtype: torch.dtype, half: str) -> dict:
    """The epilogue's registers a thread (cudaFuncGetAttributes) and
    resident blocks an SM on `device`
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), read once a device."""
    regs, blocks = _epilogue_info(_index(device),
                                  int(dtype == torch.float64), half)
    return {"registers": regs, "blocks_per_sm": blocks}


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def epilogue_launch_plan(half: str, s: torch.Tensor) -> EpiloguePlan:
    """epilogue_plan for a launch on s's card: s's rows, the card's SMs and
    the kernel's resident blocks."""
    index = _index(s.device)
    return epilogue_plan(s.numel(), _sm_count(index), _epilogue_info(
        index, int(s.dtype == torch.float64), half)[1])


def _epilogue_launch(half: str, s: torch.Tensor, out, rows, scal, inner,
                     t: int) -> None:
    lib = _tiled_lib(s)
    P = epilogue_launch_plan(half, s)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.hprlp_tiled_half_epilogue(
            int(s.dtype == torch.float64), HALF_EPILOGUES[half], s.numel(),
            P.grid, s.data_ptr(), *_ptrs(out, rows, scal, inner), t, stream)
    _raise_tiled(lib, err, f"{half}-half epilogue, {s.numel()} rows, {P}")


def empty_launch(device, grid: int, threads: int) -> None:
    """One launch of csrc/spmv_tiled.cu's empty kernel on `grid` blocks of
    `threads`: the floor that a launch on that grid costs (a measurement;
    no solve launches it)."""
    index = _index(device)
    lib = _tiled_library(index)
    with torch.cuda.device(index):
        err = lib.hprlp_tiled_empty_launch(
            grid, threads, torch.cuda.current_stream(index).cuda_stream)
    _raise_tiled(lib, err, f"empty launch, {grid} x {threads}")


def tiled_half_epilogue(half: str, s: torch.Tensor, rows, scal, inner,
                        t: int):
    """A column-sharded mesh's middle-iteration half after the all-reduce:
    each row's half-update given its summed product s (A^T y for half "x",
    A x_hat for "y"), one launch of csrc/spmv_tiled.cu's epilogue.  rows:
    the tensors HALF_ROWS[half] names, in that order (x, last_x, c, l, u or
    y, last_y, AL, AU); scal: sigma or lambda sigma; inner, t as for
    tiled_x_half.  Returns (x_new, x_hat) or y_new, as solver/chunk.py::
    x_update / y_update compute them from s.  Raises on a bad argument or
    a refused launch.  The launch's grid is epilogue_launch_plan's."""
    _check_cuda(s)
    if s.dtype not in (torch.float32, torch.float64) or s.dim() != 1 \
            or not s.is_contiguous():
        raise TypeError(f"the summed product must be a contiguous f32 or "
                        f"f64 vector, got {s.dtype} {tuple(s.shape)}")
    check_half_operands(s.numel(), s, _named_rows(half, rows), scal, inner)
    out = _half_out(half, rows)
    _epilogue_launch(half, s, out, rows, scal, inner, t)
    tiled_half_epilogue.launches += 1
    return out if half == "x" else out[0]


tiled_half_epilogue.launches = 0


def max_active_clusters(T, stage: str = MAIN_STAGE) -> int:
    """How many clusters of `stage` fit on the card at once at T's shared
    memory (cudaOccupancyMaxActiveClusters); the main stage's are clusters
    of T's G blocks.  Raises if the card refuses that cluster size."""
    lib = _tiled_library(torch.cuda.current_device())
    n = lib.hprlp_tiled_max_active_clusters(
        int(T.vals.dtype == torch.float64), TILED_STAGES[stage], T.n_groups,
        T.smem_bytes)
    _raise_tiled(lib, max(0, -n), f"residency query, {stage}, G "
                                  f"{T.n_groups}")
    return n


@functools.cache
def _cluster_slots(device_index: int) -> dict:
    lib = _tiled_library(device_index)
    slots = {}
    with torch.cuda.device(device_index):
        for G in range(1, MAX_GROUPS + 1):
            n = lib.hprlp_tiled_max_active_clusters(
                0, TILED_STAGES[MAIN_STAGE], G, SMEM_BYTES)
            _raise_tiled(lib, max(0, -n), f"residency query, G {G}")
            if n <= 0:
                raise RuntimeError(f"tiled SpMV: no cluster of {G} blocks "
                                   f"with {SMEM_BYTES} B of shared memory "
                                   f"each fits the card")
            slots[G] = n
    return slots


def cluster_slots(device) -> dict | None:
    """{G: clusters of G blocks of the main stage resident at once on
    `device`} for G = 1 .. MAX_GROUPS, each block with a block's full
    shared memory, as a tiling with G > 1 strip groups takes it (the
    count build_tiles takes to keep a tiling's chunks in one wave); None
    for a CPU device, where the tiles keep their CPU layout.  Raises if
    the card refuses a cluster size or fits none."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return dict(_cluster_slots(device.index if device.index is not None
                               else torch.cuda.current_device()))


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


def csr_spmv_plain(A, x: torch.Tensor, blocks: RowBlocks | None = None
                   ) -> torch.Tensor:
    """csrc/spmv_csr.cu's y = A @ x in plain PyTorch (any device), bit for
    bit: each product rounded, then summed by plan_row_sums.  `blocks`
    defaults to A's plan, else row_blocks(A)."""
    return plan_row_sums(A, A.vals * x[A.indices.to(torch.int64)], blocks)


def plan(A, blocks: RowBlocks | None = None) -> RowBlocks:
    """`blocks`, else A's plan, else row_blocks(A)."""
    return blocks or getattr(A, "blocks", None) or row_blocks(A)


def plan_row_sums(A, terms: torch.Tensor, blocks: RowBlocks | None = None,
                  n_acc: int = 1) -> torch.Tensor:
    """The row sums of per-entry `terms` as csrc/spmv_csr.cu forms them on
    the plan, bit for bit: a row of at most the plan's cap entries summed
    from +0 one add at a time in CSR order, its entry j into accumulator j
    % n_acc (n_acc 1, 2 or 4; the accumulators combined as (acc0 + acc1) +
    (acc2 + acc3)), and a longer row (a block alone) summed in CSR_BLOCK
    strided partials and a tree.  Any device."""
    if n_acc not in (1, 2, 4):
        raise ValueError(f"n_acc must be 1, 2 or 4, got {n_acc}")
    P = plan(A, blocks)
    dev, n, dtype = terms.device, A.nrows, terms.dtype
    indptr = A.indptr.to(device=dev, dtype=torch.int64)
    y = torch.zeros(n, dtype=dtype, device=dev)
    length = indptr[1:] - indptr[:-1]
    short = torch.ones(n, dtype=torch.bool, device=dev)
    short[long_rows(A, P)] = False
    # Short rows: add entry j of every row longer than j, j = 0, 1, ...
    rows = torch.nonzero(short).flatten()
    rows = rows[torch.argsort(length[rows], descending=True, stable=True)]
    lens = length[rows]
    acc = torch.zeros((rows.numel(), n_acc), dtype=dtype, device=dev)
    for j in range(int(lens[0]) if rows.numel() else 0):
        k = int((lens > j).sum())
        acc[:k, j % n_acc] = acc[:k, j % n_acc] + terms[indptr[rows[:k]] + j]
    while acc.shape[1] > 1:
        acc = acc[:, 0::2] + acc[:, 1::2]
    y[rows] = acc[:, 0]
    return long_row_sums(A, terms, P, y)


def long_rows(A, blocks: RowBlocks | None = None) -> list:
    """The rows that are a block alone on the plan, longer than its cap."""
    P = plan(A, blocks)
    row0, ent0 = P.row0.to(torch.int64), P.ent0.to(torch.int64)
    longb = (row0[1:] - row0[:-1] == 1) & (ent0[1:] - ent0[:-1] > P.cap)
    return row0[:-1][longb].tolist()


def long_row_sums(A, terms: torch.Tensor, blocks: RowBlocks | None,
                  y: torch.Tensor) -> torch.Tensor:
    """y with every long row (long_rows) set to the kernel's sum of its
    `terms`: CSR_BLOCK strided partials in entry order, then a fixed tree.
    Returns y."""
    dev, dtype = terms.device, terms.dtype
    indptr = A.indptr.to(device=dev, dtype=torch.int64)
    for r in long_rows(A, blocks):
        p = terms[int(indptr[r]):int(indptr[r + 1])]
        steps = -(-p.numel() // CSR_BLOCK)
        part = torch.zeros(steps * CSR_BLOCK, dtype=dtype, device=dev)
        part[:p.numel()] = p
        part = part.view(steps, CSR_BLOCK)
        s = torch.zeros(CSR_BLOCK, dtype=dtype, device=dev)
        for i in range(steps):
            s = s + part[i]
        w = CSR_BLOCK // 2
        while w:
            s = torch.cat([s[:w] + s[w:2 * w], s[2 * w:]])
            w //= 2
        y[r] = s[0]
    return y
