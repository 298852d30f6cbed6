"""The SpMV variant studies: four hand-written Hopper kernel families,
their wrappers and their plain versions.

Each family takes the place of one Pallas variant study in benchmarks/ and
asks its question of a kernel the port runs.  The ablate and multi_acc
families ablate the "gather" backend's CSR kernel on its row-block plan:
they are instantiations of csrc/spmv_csr.cu (launched by ops/spmv.py::
csr_study; `full` and `n_acc=1` are csr_spmv's own launch), whose note
says what each variant isolates, and their plain versions repeat its
order of sums on the plan (ops/spmv.py::plan_row_sums).  The flush
family's `full` is that launch too; its run-based variants, and segsum's
`mm_*`, are csrc/spmv_variants.cu's CSR kernels.  The segsum family's
exact variant, full, asks its question of the main path's tiles
(csrc/spmv_tiled.cu, template ONEHOT: one-hot tensor-core row sums in
place of the segmented warp scan); its plain version,
`segsum_onehot_plain`, builds the same one-hot products in plain PyTorch.

    family      wrapper          JAX study                variants
    ablate      spmv_ablate      prof_lane_ablate.py      dma_only, no_gather,
                                                          one_gather, no_flush,
                                                          full
    multi_acc   spmv_multi_acc   prof_dual_acc.py         n_acc=1, 2, 4
    flush       spmv_flush       prof_flush_variants.py   full, merge_all,
                                                          runmerge
    segsum      spmv_segsum      prof_kernel_variants.py  mm_fused, mm_hi1,
                                                          mm_precomp, full

A wrapper takes f32 CUDA tensors only (the CSR kernel's variants also the
matrix's row-block plan, which they never build), launches its kernel,
counts the launch and raises on a bad argument or a refused launch.
`plain` computes what each variant computes -- the deliberately wrong
ones included -- in plain PyTorch on any device (bit for bit where the
variant is `bitwise`), and `variant_spmv` sends a CUDA tensor to the
kernel and a CPU tensor to the plain version.  The libraries build with
nvcc on first use, by the rule of ops/spmv.py.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch

from .spmv import (CSR_BLOCK, CSR_VEC, DMA_ONLY, NO_FLUSH, NO_GATHER,
                   ONE_GATHER, STORE, _tiled_library, build, check_csr_args,
                   check_tiled_args, csr_spmv_plain, csr_study, plan,
                   plan_row_sums, row_of_entry, spmv_reference)
from .tiles import (SENTINEL_ROW, SMEM_BYTES, WARPS, TiledMatrix,
                    build_tiles)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "spmv_variants.cu")

RUN = 256       # nonzeros per warp in the run-based kernels (flush, segsum)
TILE = 32       # nonzeros per mma tile in segsum (one per lane)
SUB = 8         # nonzeros per mma product (k of m16n8k8) in segsum
RANKS = 16      # rows per mma product (m of m16n8k8)
SEG_SUB = 16    # entries per one-hot product of segsum full (k of m16n8k16)
SEG_STEP = 128  # entries per warp step of the tiled kernel (32 lanes x 4)
# segsum full's per-warp staging of mma fragments, ranks and rank-to-row
# tables (csrc/spmv_tiled.cu kSegsumBytes), on top of the tiles' own
# shared memory.
SEG_SMEM_BYTES = 16 * (8 * 3 * 4 * 8 + 8 * 4 * 4 + 8 * 16 * 2)
WINDOW = 16384  # x entries per window in ablate/one_gather (128 x 128)
_BF16_ONE = 0x3F80


@dataclasses.dataclass(frozen=True)
class Variant:
    code: int        # the variant's number in its CUDA source (multi_acc:
    #                  n_acc)
    kind: str        # "exact" (computes A @ x) or "timing_only"
    tol: float       # max abs error against the plain version, / max|y|
    translates: str  # the JAX study and variant it stands for
    bitwise: bool    # the kernel gives its plain version's bits

    @property
    def exact(self) -> bool:
        return self.kind == "exact"


def _table(study, rows):
    return {name: Variant(code, kind, tol, f"benchmarks/{study} {jax_name}",
                          bitwise)
            for name, code, kind, tol, jax_name, bitwise in rows}


VARIANTS: dict[str, dict[str, Variant]] = {
    "ablate": _table("prof_lane_ablate.py", [
        ("dma_only", DMA_ONLY, "timing_only", 1e-5, "dma_only", False),
        ("no_gather", NO_GATHER, "timing_only", 1e-5, "no_gather", False),
        ("one_gather", ONE_GATHER, "timing_only", 1e-5, "one_gather", False),
        ("no_flush", NO_FLUSH, "timing_only", 1e-5, "no_flush", False),
        ("full", STORE, "exact", 1e-5, "full", True)]),
    "multi_acc": _table("prof_dual_acc.py", [
        (f"n_acc={n}", n, "exact", 1e-5, f"n_acc={n}", True)
        for n in (1, 2, 4)]),
    "flush": _table("prof_flush_variants.py", [
        ("full", STORE, "exact", 1e-5, "full", True),
        ("merge_all", 1, "timing_only", 1e-5, "merge_all", False),
        ("runmerge", 2, "exact", 1e-5, "runmerge", False)]),
    # mm_precomp carries p as two bf16 terms (~2^-16 relative): 1e-4.
    "segsum": _table("prof_kernel_variants.py", [
        ("mm_fused", 3, "timing_only", 1e-5, "mm_fused", False),
        ("mm_hi1", 2, "timing_only", 1e-5, "mm_hi1", False),
        ("mm_precomp", 1, "exact", 1e-4, "mm_precomp", False),
        ("full", 0, "exact", 1e-5, "full", False)]),
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
        "hprlp_spmv_flush": [i, i, ll] + [ptr] * 6,
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
    """The "gather" backend's CSR kernel on A's row-block plan with one
    part taken out (dma_only, no_gather, one_gather, no_flush), or whole
    (full: csr_spmv's launch)."""
    v = variant("ablate", variant_name)
    y = csr_study(v.code, 1, A, x)
    spmv_ablate.launches += 1
    return y


def spmv_multi_acc(A, x: torch.Tensor, variant_name: str) -> torch.Tensor:
    """The CSR kernel on A's row-block plan with each short row summed in
    n_acc accumulators (n_acc=1: csr_spmv's launch)."""
    v = variant("multi_acc", variant_name)
    y = csr_study(STORE, v.code, A, x)
    spmv_multi_acc.launches += 1
    return y


def spmv_flush(A, x: torch.Tensor, variant_name: str) -> torch.Tensor:
    """Per-row sums and one store per row (full: csr_spmv's launch, on A's
    row-block plan) against nnz-balanced runs flushed at row ends
    (runmerge) or not at all (merge_all)."""
    v = variant("flush", variant_name)
    if variant_name == "full":
        y = csr_study(STORE, 1, A, x)
        spmv_flush.launches += 1
        return y
    _check(A, x)
    # The run-based variants add into y with atomics.
    y = torch.zeros(A.nrows, dtype=x.dtype, device=x.device)
    _launch(spmv_flush, "hprlp_spmv_flush", x, v.code, A.nrows, A.nnz,
            *_csr_ptrs(A, x, y))
    return y


def segsum_tiles(A) -> TiledMatrix:
    """A's tiles for segsum full: build_tiles' layout, with strips narrowed
    where the kernel's staging (SEG_SMEM_BYTES) would not fit beside
    them."""
    T = build_tiles(A)
    while T.smem_bytes + SEG_SMEM_BYTES > SMEM_BYTES:
        ys = T.smem_bytes - (2 if T.group_strips > 1 else 1) \
            * T.strip_width * T.vals.element_size()
        W = (SMEM_BYTES - SEG_SMEM_BYTES - ys) // (2 * T.vals
                                                      .element_size())
        T = build_tiles(A, strip_width=min(W // 32 * 32,
                                           T.strip_width - 32))
    return T


def _segsum_full(A, x: torch.Tensor, tiles: TiledMatrix | None
                 ) -> torch.Tensor:
    """segsum full: the tiled kernel with one-hot tensor-core row sums, on
    `tiles` (else A's own, else segsum_tiles(A))."""
    T = tiles if tiles is not None else (
        A.tiles if getattr(A, "tiles", None) is not None
        else segsum_tiles(A))
    check_tiled_args(T, x)
    if (T.nrows, T.ncols) != (A.nrows, A.ncols):
        raise ValueError("the tiles are of another matrix")
    if T.smem_bytes + SEG_SMEM_BYTES > SMEM_BYTES:
        raise ValueError(f"tiles of {T.smem_bytes} B shared memory leave no "
                         f"room for segsum's {SEG_SMEM_BYTES} B of staging: "
                         f"build them with segsum_tiles")
    y = torch.empty(T.nrows, dtype=x.dtype, device=x.device)
    if T.nnz == 0:
        return y.zero_()
    part = (torch.empty(T.n_groups * T.nrows, dtype=x.dtype, device=x.device)
            if T.n_groups > 1 else None)
    lib = _tiled_library(x.device.index if x.device.index is not None
                         else torch.cuda.current_device())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hprlp_tiled_segsum(
            T.nrows, T.ncols, T.strip_width, T.n_strips, T.n_groups,
            T.group_strips, T.n_chunks, T.max_block_rows, T.vals.data_ptr(),
            T.keys.data_ptr(), T.runs.data_ptr(), T.row_start.data_ptr(),
            x.data_ptr(), None if part is None else part.data_ptr(),
            y.data_ptr(), stream)
    if err != 0:
        msg = lib.hprlp_tiled_error_string(err).decode()
        raise RuntimeError(f"hprlp_tiled_segsum launch failed: {msg} ({err})")
    spmv_segsum.launches += 1
    return y


def spmv_segsum(A, x: torch.Tensor, variant_name: str,
                rtiles: torch.Tensor | None = None,
                tiles: TiledMatrix | None = None) -> torch.Tensor:
    """K4: products summed by row with tensor-core one-hot products.  full
    runs on `tiles` (A's, or segsum_tiles(A), built here if not given);
    mm_precomp reads `rtiles` (segsum_rtiles(A), built here if not
    given)."""
    v = variant("segsum", variant_name)
    _check(A, x)
    if variant_name == "full":
        return _segsum_full(A, x, tiles)
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


def _entry_blocks(A, P) -> torch.Tensor:
    """The block of plan P that owns each stored entry (int64, on A's
    device): the last block whose first entry is at or before it."""
    k = torch.arange(A.nnz, device=A.vals.device)
    return torch.searchsorted(P.ent0.to(k.device, torch.int64), k,
                              right=True) - 1


def _no_flush_plain(A, x, P):
    """no_flush: each thread's products, in entry order, stored to row r0 +
    tid of its block (dropped past the block's last row); a long row's
    block stores thread 0's strided partial alone."""
    dev = x.device
    row0, ent0 = P.row0.to(dev, torch.int64), P.ent0.to(dev, torch.int64)
    k = torch.arange(A.nnz, device=dev)
    b = _entry_blocks(A, P)
    r0, r1, e0 = row0[b], row0[b + 1], ent0[b]
    long = (r1 - r0 == 1) & (ent0[b + 1] - e0 > P.cap)
    tid = torch.where(long, (k - e0) % CSR_BLOCK,
                      (k // CSR_VEC - e0 // CSR_VEC) % CSR_BLOCK)
    kept = torch.where(long, tid == 0, r0 + tid < r1)
    prod = A.vals * x[A.indices.to(torch.int64)]
    return torch.zeros(A.nrows, dtype=x.dtype, device=dev).index_add_(
        0, (r0 + tid)[kept], prod[kept])


def _ablate_plain(A, x, name):
    P = plan(A)
    if name == "full":
        return csr_spmv_plain(A, x, P)
    if name == "no_flush":
        return _no_flush_plain(A, x, P)
    idx = A.indices.to(torch.int64)
    if name == "dma_only":
        terms = A.vals + A.indices.to(A.vals.dtype)
    elif name == "no_gather":
        k = torch.arange(A.nnz, device=x.device)
        terms = A.vals * x[k & (_pow2_floor(A.ncols) - 1)]
    else:  # one_gather: block b's reads in window b mod (ncols / W)
        win = min(WINDOW, _pow2_floor(A.ncols))
        base = (_entry_blocks(A, P) % max(A.ncols // win, 1)) * win
        terms = A.vals * x[base + (idx & (win - 1))]
    return plan_row_sums(A, terms, P)


def _multi_acc_plain(A, x, name):
    return plan_row_sums(A, A.vals * x[A.indices.to(torch.int64)], None,
                         variant("multi_acc", name).code)


def _flush_plain(A, x, name):
    if name == "full":
        return csr_spmv_plain(A, x)
    if name == "runmerge":
        return spmv_reference(A, x)
    # Each run's sum, added into row (run % nrows).
    nruns = -(-A.nnz // RUN)
    run = torch.arange(A.nnz, device=x.device) // RUN
    sums = torch.zeros(nruns, dtype=x.dtype, device=x.device).index_add_(
        0, run, A.vals * x[A.indices.to(torch.int64)])
    return _row_sums(A, sums,
                     torch.arange(nruns, device=x.device) % max(A.nrows, 1))


def segsum_subblocks(T: TiledMatrix) -> dict:
    """segsum full's one-hot products on tiles T, as the kernel forms them:
    every warp run is cut into steps of SEG_STEP and sub-blocks of SEG_SUB
    entries from its start; an entry's rank is the number of distinct rows
    before it in its sub-block.  Returns (int64, on T's device) "sub" (the
    sub-block of each tile position), "pos" (its place in the sub-block),
    "rank", "row" (its row; padding gets nrows) and "row_of_rank"
    (n_sub, SEG_SUB): the row each rank sums into (nrows where no entry
    has the rank)."""
    dev = T.keys.device
    L = T.vals.shape[0]
    counts = (T.runs[1:] - T.runs[:-1]).to(torch.int64)
    run = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                  counts, output_size=L)
    at = torch.arange(L, device=dev) - T.runs.to(torch.int64)[run]
    key = T.keys.to(torch.int64) & 0xFFFFFFFF
    rib = key >> 16
    block = run // (T.group_strips * WARPS)
    chunk = block % T.n_chunks
    row = torch.where(rib == SENTINEL_ROW, T.nrows,
                      T.row_start.to(torch.int64)[chunk] + rib)
    # Sub-blocks never straddle a run: number them run by run.
    per_run = -(-counts // SEG_SUB)
    first = torch.cumsum(per_run, 0) - per_run
    sub = first[run] + at // SEG_SUB
    pos = at % SEG_SUB
    new = torch.ones(L, dtype=torch.bool, device=dev)
    new[1:] = (sub[1:] != sub[:-1]) | (row[1:] != row[:-1])
    new_row = new.clone()
    new_row[pos == 0] = False  # rank 0 opens every sub-block
    rank = torch.cumsum(new_row.to(torch.int64), 0)
    start = torch.where(pos == 0, rank, 0)
    rank = rank - torch.cummax(start, 0).values
    n_sub = int(per_run.sum())
    row_of_rank = torch.full((n_sub, SEG_SUB), T.nrows, dtype=torch.int64,
                             device=dev)
    row_of_rank[sub[new], rank[new]] = row[new]
    return {"sub": sub, "pos": pos, "rank": rank, "row": row,
            "row_of_rank": row_of_rank}


def _bf16_terms(p: torch.Tensor) -> torch.Tensor:
    """(len, 3): the exact three-term bf16 split hi, mid, lo of f32 p, as
    the kernel's bf16_term makes it (hi + mid + lo == p)."""
    hi = _bf16(p)
    r1 = p - hi
    mid = _bf16(r1)
    return torch.stack([hi, mid, _bf16(r1 - mid)], dim=-1)


def segsum_onehot_plain(T: TiledMatrix, x: torch.Tensor) -> torch.Tensor:
    """segsum full in plain PyTorch (any device): per sub-block C = R P with
    R the one-hot (SEG_SUB ranks x SEG_SUB entries) and P the products'
    bf16 terms, each rank's (hi + mid) + lo added into its row in sub-block
    order.  The products of R P are exact; the kernel's tensor cores add
    them in f32 in an order of their own."""
    sb = segsum_subblocks(T)
    col = T.coo[2][torch.argsort(T.coo[0])]  # column of each tile position
    p = T.vals * x[torch.clamp(col, max=T.ncols - 1)]
    n_sub = sb["row_of_rank"].shape[0]
    R = torch.zeros((n_sub, SEG_SUB, SEG_SUB), dtype=torch.float64,
                    device=x.device)
    R[sb["sub"], sb["rank"], sb["pos"]] = 1.0
    P = torch.zeros((n_sub, SEG_SUB, 3), dtype=torch.float64,
                    device=x.device)
    P[sb["sub"], sb["pos"]] = _bf16_terms(p).to(torch.float64)
    C = (R @ P).to(torch.float32)
    sums = (C[..., 0] + C[..., 1]) + C[..., 2]
    y = torch.zeros(T.nrows + 1, dtype=torch.float32, device=x.device)
    return y.index_add_(0, sb["row_of_rank"].flatten(), sums.flatten()
                        )[:T.nrows]


def _segsum_plain(A, x, name, tiles=None):
    if name == "full":
        T = tiles if tiles is not None else (
            A.tiles if getattr(A, "tiles", None) is not None
            else segsum_tiles(A))
        return segsum_onehot_plain(T, x)
    p = A.vals * x[A.indices.to(torch.int64)]
    if name == "mm_fused":
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


_PLAIN = {"ablate": _ablate_plain, "multi_acc": _multi_acc_plain,
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
