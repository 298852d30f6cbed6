"""The SpMV variant studies: four hand-written Hopper kernel families
(csrc/spmv_variants.cu), their wrappers and their plain versions.

Each family takes the place of one Pallas variant study in benchmarks/ and
ablates the port's row-parallel CSR kernel (csrc/spmv.cu) the way that
study ablated the TPU kernel; the CUDA source's note says what each
variant isolates.

    family      wrapper          JAX study                variants
    ablate      spmv_ablate      prof_lane_ablate.py      dma_only, no_gather,
                                                          one_gather, no_flush,
                                                          full
    multi_acc   spmv_multi_acc   prof_dual_acc.py         n_acc=1, 2, 4
    flush       spmv_flush       prof_flush_variants.py   full, merge_all,
                                                          runmerge
    segsum      spmv_segsum      prof_kernel_variants.py  mm_fused, mm_hi1,
                                                          mm_precomp, full

A wrapper takes f32 CUDA tensors only, launches its kernel, counts the
launch and raises on a bad argument or a refused launch.  `plain` computes
what each variant computes -- the deliberately wrong ones included -- in
plain PyTorch on any device, and `variant_spmv` sends a CUDA tensor to the
kernel and a CPU tensor to the plain version.  The library builds with
nvcc on first use, by the rule of ops/spmv.py.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch

from .spmv import (build, check_csr_args, row_of_entry, spmv_reference,
                   threads_per_row)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "spmv_variants.cu")

RUN = 256       # nonzeros per warp in the run-based kernels (flush, segsum)
TILE = 32       # nonzeros per mma tile in segsum (one per lane)
SUB = 8         # nonzeros per mma product (k of m16n8k8) in segsum
RANKS = 16      # rows per mma product (m of m16n8k8)
WINDOW = 16384  # x entries per window in ablate/one_gather (128 x 128)
_BF16_ONE = 0x3F80


@dataclasses.dataclass(frozen=True)
class Variant:
    code: int        # the variant's number in the CUDA source
    kind: str        # "exact" (computes A @ x) or "timing_only"
    tol: float       # max abs error against the plain version, / max|y|
    translates: str  # the JAX study and variant it stands for

    @property
    def exact(self) -> bool:
        return self.kind == "exact"


def _table(study, rows):
    return {name: Variant(code, kind, tol, f"benchmarks/{study} {jax_name}")
            for name, code, kind, tol, jax_name in rows}


VARIANTS: dict[str, dict[str, Variant]] = {
    "ablate": _table("prof_lane_ablate.py", [
        ("dma_only", 1, "timing_only", 1e-5, "dma_only"),
        ("no_gather", 2, "timing_only", 1e-5, "no_gather"),
        ("one_gather", 3, "timing_only", 1e-5, "one_gather"),
        ("no_flush", 4, "timing_only", 1e-5, "no_flush"),
        ("full", 0, "exact", 1e-5, "full")]),
    "multi_acc": _table("prof_dual_acc.py", [
        (f"n_acc={n}", n, "exact", 1e-5, f"n_acc={n}") for n in (1, 2, 4)]),
    "flush": _table("prof_flush_variants.py", [
        ("full", 0, "exact", 1e-5, "full"),
        ("merge_all", 1, "timing_only", 1e-5, "merge_all"),
        ("runmerge", 2, "exact", 1e-5, "runmerge")]),
    # mm_precomp carries p as two bf16 terms (~2^-16 relative): 1e-4.
    "segsum": _table("prof_kernel_variants.py", [
        ("mm_fused", 3, "timing_only", 1e-5, "mm_fused"),
        ("mm_hi1", 2, "timing_only", 1e-5, "mm_hi1"),
        ("mm_precomp", 1, "exact", 1e-4, "mm_precomp"),
        ("full", 0, "exact", 1e-5, "full")]),
}


def variant(family: str, name: str) -> Variant:
    try:
        return VARIANTS[family][name]
    except KeyError:
        raise ValueError(f"unknown variant {family}/{name}") from None


# ----------------------------------------------------------------- kernels

@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build(SOURCE))
    i, ll, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    argtypes = {
        "hprlp_spmv_ablate": [i, i, i, i] + [ptr] * 6,
        "hprlp_spmv_multi_acc": [i, i, i] + [ptr] * 6,
        "hprlp_spmv_flush": [i, i, i, i, ll] + [ptr] * 6,
        "hprlp_spmv_segsum": [i, i, ll] + [ptr] * 7,
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    lib.hprlp_variants_error_string.argtypes = [ctypes.c_int]
    lib.hprlp_variants_error_string.restype = ctypes.c_char_p
    return lib


def _check(A, x: torch.Tensor) -> None:
    check_csr_args(A, x)
    if x.dtype != torch.float32:
        raise TypeError(f"the variant kernels are f32 only, got {x.dtype}")


def _launch(wrapper, fn_name: str, x: torch.Tensor, *args) -> None:
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        msg = lib.hprlp_variants_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({err})")
    wrapper.launches += 1


def _csr_ptrs(A, x, y):
    return (A.indptr.data_ptr(), A.indices.data_ptr(), A.vals.data_ptr(),
            x.data_ptr(), y.data_ptr())


def spmv_ablate(A, x: torch.Tensor, variant_name: str) -> torch.Tensor:
    """K1: the row-parallel kernel with one part taken out (full, dma_only,
    no_gather, one_gather, no_flush)."""
    v = variant("ablate", variant_name)
    _check(A, x)
    y = torch.empty(A.nrows, dtype=x.dtype, device=x.device)
    _launch(spmv_ablate, "hprlp_spmv_ablate", x, v.code,
            threads_per_row(A.nnz, A.nrows), A.nrows, A.ncols,
            *_csr_ptrs(A, x, y))
    return y


def spmv_multi_acc(A, x: torch.Tensor, variant_name: str) -> torch.Tensor:
    """K2: the row-parallel kernel with n_acc partial sums per thread."""
    v = variant("multi_acc", variant_name)
    _check(A, x)
    y = torch.empty(A.nrows, dtype=x.dtype, device=x.device)
    _launch(spmv_multi_acc, "hprlp_spmv_multi_acc", x, v.code,
            threads_per_row(A.nnz, A.nrows), A.nrows, *_csr_ptrs(A, x, y))
    return y


def spmv_flush(A, x: torch.Tensor, variant_name: str) -> torch.Tensor:
    """K3: per-row flush (full) against nnz-balanced runs flushed at row
    ends (runmerge) or not at all (merge_all)."""
    v = variant("flush", variant_name)
    _check(A, x)
    # The run-based variants add into y with atomics.
    alloc = torch.empty if variant_name == "full" else torch.zeros
    y = alloc(A.nrows, dtype=x.dtype, device=x.device)
    _launch(spmv_flush, "hprlp_spmv_flush", x, v.code,
            threads_per_row(A.nnz, A.nrows), A.nrows, A.ncols, A.nnz,
            *_csr_ptrs(A, x, y))
    return y


def spmv_segsum(A, x: torch.Tensor, variant_name: str,
                rtiles: torch.Tensor | None = None) -> torch.Tensor:
    """K4: products summed by row with tensor-core one-hot products.
    mm_precomp reads `rtiles` (segsum_rtiles(A), built here if not
    given)."""
    v = variant("segsum", variant_name)
    _check(A, x)
    if variant_name == "mm_precomp":
        if rtiles is None:
            rtiles = segsum_rtiles(A)
        if rtiles.device != x.device or rtiles.dtype != torch.int32 \
                or rtiles.shape != (-(-A.nnz // SUB), 32, 2) \
                or not rtiles.is_contiguous():
            raise ValueError("rtiles must be segsum_rtiles(A) on x's device")
        rt_ptr = rtiles.data_ptr()
    else:
        rt_ptr = None
    y = torch.zeros(A.nrows, dtype=x.dtype, device=x.device)
    indptr, indices, vals, xp, yp = _csr_ptrs(A, x, y)
    _launch(spmv_segsum, "hprlp_spmv_segsum", x, v.code, A.nrows, A.nnz,
            indptr, indices, vals, xp, rt_ptr, yp)
    return y


WRAPPERS = {"ablate": spmv_ablate, "multi_acc": spmv_multi_acc,
            "flush": spmv_flush, "segsum": spmv_segsum}
for _w in WRAPPERS.values():
    _w.launches = 0


def segsum_rtiles(A) -> torch.Tensor:
    """The one-hot R of every 8-entry sub-block for segsum/mm_precomp, as
    bf16 in the A-fragment order of mma m16n8k8: (ceil(nnz/8), 32 lanes,
    2) int32, lane 4g + t holding (R[g][2t], R[g][2t+1]) and (R[g+8][2t],
    R[g+8][2t+1]), the lower column in the low half.  R[r][k] = 1 where
    entry k lies r rows past the sub-block's first entry (r < 16)."""
    nsub = -(-A.nnz // SUB)
    rows = row_of_entry(A)
    pad = rows.new_full((nsub * SUB - A.nnz,), -1)  # matches no rank
    rows = torch.cat([rows, pad]).view(nsub, SUB)
    ranks = torch.where(rows >= 0, rows - rows[:, :1], -1)
    lane = torch.arange(32, device=rows.device)
    g, t = lane >> 2, lane & 3
    r0, r1 = ranks[:, 2 * t], ranks[:, 2 * t + 1]

    def pack(rank_g):
        return ((r0 == rank_g) * _BF16_ONE) | ((r1 == rank_g) * _BF16_ONE << 16)

    return torch.stack([pack(g), pack(g + 8)], dim=-1).to(torch.int32)


# ---------------------------------------------------------- plain versions

def _pow2_floor(v: int) -> int:
    return 1 << (max(v, 1).bit_length() - 1)


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """TF32 rounding (to nearest, ties away from zero) in f32 layout, as
    the kernel's tf32_bits."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def _row_sums(A, per_entry: torch.Tensor, rows=None) -> torch.Tensor:
    rows = row_of_entry(A) if rows is None else rows
    return torch.zeros(A.nrows, dtype=per_entry.dtype,
                       device=per_entry.device).index_add_(0, rows, per_entry)


def _ablate_plain(A, x, name):
    if name == "full":
        return spmv_reference(A, x)
    idx = A.indices.to(torch.int64)
    rows = row_of_entry(A)
    k = torch.arange(A.nnz, device=x.device)
    if name == "dma_only":
        per_entry = A.vals + A.indices.to(A.vals.dtype)
    elif name == "no_gather":
        mask = _pow2_floor(A.ncols) - 1
        per_entry = A.vals * x[torch.bitwise_xor(k, idx >> 31) & mask]
    elif name == "one_gather":
        win = min(WINDOW, _pow2_floor(A.ncols))
        base = ((rows >> 7) % max(A.ncols // win, 1)) * win
        per_entry = A.vals * x[base + (idx & (win - 1))]
    else:  # no_flush: lane 0's partial, the entries at offsets 0, TPR, ...
        tpr = threads_per_row(A.nnz, A.nrows)
        lane0 = (k - A.indptr[rows]) % tpr == 0
        per_entry = torch.where(lane0, A.vals * x[idx], 0.0)
    return _row_sums(A, per_entry, rows)


def _flush_plain(A, x, name):
    if name != "merge_all":
        return spmv_reference(A, x)
    # Each run's sum, added into row (run % nrows).
    nruns = -(-A.nnz // RUN)
    run = torch.arange(A.nnz, device=x.device) // RUN
    sums = torch.zeros(nruns, dtype=x.dtype, device=x.device).index_add_(
        0, run, A.vals * x[A.indices.to(torch.int64)])
    return _row_sums(A, sums,
                     torch.arange(nruns, device=x.device) % max(A.nrows, 1))


def _segsum_plain(A, x, name):
    p = A.vals * x[A.indices.to(torch.int64)]
    if name in ("full", "mm_fused"):
        hi = _tf32(p)
        per_entry = hi + _tf32(p - hi)
    elif name == "mm_precomp":
        hi = _bf16(p)
        per_entry = hi + _bf16(p - hi)
    else:  # mm_hi1
        per_entry = _bf16(p)
    rows = row_of_entry(A)
    if name == "mm_fused":
        # Every entry of a 32-entry tile goes to the tile's first row plus
        # its rank, clamped to 15.
        first = rows[torch.arange(A.nnz, device=x.device) // TILE * TILE]
        rows = first + torch.clamp(rows - first, max=RANKS - 1)
    return _row_sums(A, per_entry, rows)


_PLAIN = {"ablate": _ablate_plain,
          "multi_acc": lambda A, x, name: spmv_reference(A, x),
          "flush": _flush_plain, "segsum": _segsum_plain}


def plain(family: str, A, x: torch.Tensor, variant_name: str) -> torch.Tensor:
    """What `family`/`variant_name` computes, in plain PyTorch on any
    device (finite inputs; the atomics' order aside)."""
    variant(family, variant_name)
    return _PLAIN[family](A, x, variant_name)


def variant_spmv(family: str, A, x: torch.Tensor,
                 variant_name: str) -> torch.Tensor:
    """A CUDA tensor goes to the family's kernel (which raises on
    failure); a CPU tensor goes to the plain version."""
    if x.device.type == "cuda":
        return WRAPPERS[family](A, x, variant_name)
    if x.device.type == "cpu":
        return plain(family, A, x, variant_name)
    raise ValueError(f"unsupported device {x.device}")
