"""The SpMV variant studies: four hand-written Hopper kernel families,
their wrappers and their plain versions.

Each family takes the place of one Pallas variant study in benchmarks/ and
asks its question of a kernel the port runs, on the layout a solve runs
it on.  The ablate, multi_acc and flush families ablate the "gather"
backend's CSR kernel on its row-block plan: they are instantiations of
csrc/spmv_csr.cu (launched by ops/spmv.py::csr_study; `full` and `n_acc=1`
are csr_spmv's own launch), whose note says what each variant isolates.
Their plain versions repeat its order of sums on the plan (ops/spmv.py::
plan_row_sums; runmerge's segmented warp scan: `runmerge_plain`).  The
segsum family runs on the main path's tiles: csrc/spmv_tiled.cu, template
SEG (one-hot tensor-core row sums in place of the segmented warp scan);
mm_precomp reads its R from `segsum_rtiles`, built outside the kernel.
Its plain versions are built from the same sub-blocks (`segsum_subblocks`).

    family      wrapper          JAX study                variants
    ablate      spmv_ablate      prof_lane_ablate.py      dma_only, no_gather,
                                                          one_gather, no_flush,
                                                          full
    multi_acc   spmv_multi_acc   prof_dual_acc.py         n_acc=1, 2, 4
    flush       spmv_flush       prof_flush_variants.py   full, merge_all,
                                                          runmerge
    segsum      spmv_segsum      prof_kernel_variants.py  mm_fused, mm_hi1,
                                                          mm_precomp, full

A wrapper takes f32 CUDA tensors only (and the matrix's row-block plan or
tiles, which the plan's variants never build), launches its kernel,
counts the launch and raises on a bad argument or a refused launch.
`plain` computes what each variant computes -- the deliberately wrong
ones included -- in plain PyTorch on any device (bit for bit where the
variant is `bitwise`), and `variant_spmv` sends a CUDA tensor to the
kernel and a CPU tensor to the plain version.  The two libraries build
with nvcc on first use, by the rule of ops/spmv.py.
"""

from __future__ import annotations

import dataclasses

import torch

from .spmv import (CSR_BLOCK, CSR_VEC, DMA_ONLY, MERGE_ALL, NO_FLUSH,
                   NO_GATHER, ONE_GATHER, RUN_MERGE, STORE, _partials,
                   _tiled_library,
                   check_tiled_args, csr_spmv_plain, csr_study,
                   group_sum_kernel, long_row_sums, plan, plan_row_sums, row_of_entry)
from .tiles import (SENTINEL_ROW, SMEM_BYTES, WARPS, TiledMatrix,
                    build_tiles)

SEG_SUB = 16    # entries per one-hot product of segsum (k of m16n8k16)
SEG_STEP = 128  # entries per warp step of the tiled kernel (32 lanes x 4)
SEG_RANKS = 16  # rows per one-hot product (m of the mma): mm_fused's clamp
FLUSH_SEG = 32 * CSR_VEC  # entries per warp segment of runmerge, merge_all
# Each segsum variant's per-block staging (csrc/spmv_tiled.cu
# kSegsumBytes<SEG>), on top of the tiles' own shared memory: 16 warps of
# B fragments (8 sub-blocks x terms x 4 lanes x 8 B), full's and mm_hi1's
# ranks (8 x 4 x 4 B) and rank-to-row tables (8 x 16 x 2 B); mm_fused's
# TF32 hi and lo (128 x 4 B each) and ranks (128 B).
SEG_SMEM_BYTES = {
    "full": WARPS * (8 * 3 * 4 * 8 + 8 * 4 * 4 + 8 * 16 * 2),
    "mm_precomp": WARPS * (8 * 2 * 4 * 8),
    "mm_hi1": WARPS * (8 * 1 * 4 * 8 + 8 * 4 * 4 + 8 * 16 * 2),
    "mm_fused": WARPS * (128 * 4 * 2 + 128),
}
WINDOW = 16384  # x entries per window in ablate/one_gather (128 x 128)


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
        ("merge_all", MERGE_ALL, "timing_only", 1e-5, "merge_all", False),
        ("runmerge", RUN_MERGE, "exact", 1e-5, "runmerge", True)]),
    # csrc/spmv_tiled.cu's SEG.  mm_precomp carries p as two bf16 terms
    # (~2^-16 relative): 1e-4.
    "segsum": _table("prof_kernel_variants.py", [
        ("mm_fused", 4, "timing_only", 1e-5, "mm_fused", False),
        ("mm_hi1", 3, "timing_only", 1e-5, "mm_hi1", False),
        ("mm_precomp", 2, "exact", 1e-4, "mm_precomp", False),
        ("full", 1, "exact", 1e-5, "full", False)]),
}


def variant(family: str, name: str) -> Variant:
    try:
        return VARIANTS[family][name]
    except KeyError:
        raise ValueError(f"unknown variant {family}/{name}") from None


# ----------------------------------------------------------------- kernels

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
    """The CSR kernel on A's row-block plan with per-row sums and one store
    per row (full: csr_spmv's launch), flushed at row ends by a segmented
    warp scan (runmerge), or not at all (merge_all)."""
    v = variant("flush", variant_name)
    y = csr_study(v.code, 1, A, x)
    spmv_flush.launches += 1
    return y


def segsum_tiles(A) -> TiledMatrix:
    """A's tiles for the segsum study: build_tiles' layout, with strips
    narrowed where the largest variant staging (SEG_SMEM_BYTES) would not
    fit beside them."""
    seg = max(SEG_SMEM_BYTES.values())
    T = build_tiles(A)
    while T.smem_bytes + seg > SMEM_BYTES:
        ys = T.smem_bytes - (2 if T.group_strips > 1 else 1) \
            * T.strip_width * T.vals.element_size()
        W = (SMEM_BYTES - seg - ys) // (2 * T.vals.element_size())
        T = build_tiles(A, strip_width=min(W // 32 * 32,
                                           T.strip_width - 32))
    return T


def _segsum_tiles_of(A, tiles: TiledMatrix | None) -> TiledMatrix:
    """`tiles`, else A's own, else segsum_tiles(A)."""
    if tiles is not None:
        return tiles
    if getattr(A, "tiles", None) is not None:
        return A.tiles
    return segsum_tiles(A)


@dataclasses.dataclass(frozen=True)
class SegRanks:
    """mm_precomp's R on tiles T, built outside the kernel (segsum_rtiles),
    by warp step: the steps of SEG_STEP entries numbered run by run, 8
    sub-blocks of 16 entries each, as segsum_subblocks cuts them.  uint16
    values are held in int16 tensors."""

    ranks: torch.Tensor  # (n_steps, 4, 8) int16: [step, t, q] holds the
    #                      ranks of sub-block q's entries 4t .. 4t + 3
    #                      (the mma's k = 2t, 2t + 1, 2t + 8, 2t + 9), four
    #                      bits each from the lowest
    rows: torch.Tensor   # (n_steps, 8, 8, 2) int16: [step, g, q] the rows
    #                      in its chunk of sub-block q's ranks g and g + 8,
    #                      SENTINEL_ROW where no entry has the rank
    step0: torch.Tensor  # (n_runs + 1,) int32: each run's first step
    runs: torch.Tensor   # T.runs: the layout it was built for

    @property
    def nbytes(self) -> int:
        """Bytes the kernel reads of it (each array once)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.ranks, self.rows, self.step0))


def segsum_rtiles(T: TiledMatrix) -> SegRanks:
    """mm_precomp's R on tiles T: every 16-entry sub-block's 16 four-bit
    ranks in A-fragment order (8 B) and its rank-to-row table (32 B), laid
    out by warp step so that a lane loads its part of a step at once; a
    one-hot R is its ranks.  Positions past a run's end get rank 0 (the
    kernel gives them zero products); a run's last step is padded with
    empty sub-blocks."""
    sb = segsum_subblocks(T)
    dev = T.keys.device
    counts = (T.runs[1:] - T.runs[:-1]).to(torch.int64)
    per_run = -(-counts // SEG_STEP)
    step0 = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                       torch.cumsum(per_run, 0)])
    n_steps = int(step0[-1])
    step = step0[sb["run"]] + sb["at"] // SEG_STEP
    q = sb["at"] % SEG_STEP // SEG_SUB
    pos = sb["pos"]
    ranks = torch.zeros(n_steps * 4 * 8, dtype=torch.int64, device=dev)
    ranks.index_add_(0, (step * 4 + pos // 4) * 8 + q,
                     sb["rank"] << (4 * (pos % 4)))
    rows = torch.full((n_steps * 8 * 8 * 2,), SENTINEL_ROW,
                      dtype=torch.int64, device=dev)
    rows[((step * 8 + sb["rank"] % 8) * 8 + q) * 2 + sb["rank"] // 8] = \
        sb["rib"]

    def u16(v, *shape):
        return torch.where(v >= 1 << 15, v - (1 << 16), v).to(
            torch.int16).view(*shape)

    return SegRanks(ranks=u16(ranks, n_steps, 4, 8),
                    rows=u16(rows, n_steps, 8, 8, 2),
                    step0=step0.to(torch.int32), runs=T.runs)


def spmv_segsum(A, x: torch.Tensor, variant_name: str,
                rtiles: SegRanks | None = None,
                tiles: TiledMatrix | None = None) -> torch.Tensor:
    """K4: products summed by row with tensor-core one-hot products on
    `tiles` (A's, or segsum_tiles(A), built here if not given); mm_precomp
    reads `rtiles` (segsum_rtiles of those tiles, built here if not
    given).  Raises on f64, tiles of another matrix or without room for
    the variant's staging, R of other tiles, or a refused launch."""
    v = variant("segsum", variant_name)
    if x.dtype != torch.float32:
        raise TypeError(f"the variant kernels are f32 only, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got "
                         f"{x.device}")
    T = _segsum_tiles_of(A, tiles)
    check_tiled_args(T, x)
    if (T.nrows, T.ncols) != (A.nrows, A.ncols):
        raise ValueError("the tiles are of another matrix")
    seg = SEG_SMEM_BYTES[variant_name]
    if T.smem_bytes + seg > SMEM_BYTES:
        raise ValueError(f"tiles of {T.smem_bytes} B shared memory leave no "
                         f"room for segsum {variant_name}'s {seg} B of "
                         f"staging: build them with segsum_tiles")
    rt = (None,) * 3
    if variant_name == "mm_precomp":
        if rtiles is None:
            rtiles = segsum_rtiles(T)
        if rtiles.runs is not T.runs or any(
                t.device != x.device or not t.is_contiguous()
                for t in (rtiles.ranks, rtiles.rows, rtiles.step0)) \
                or rtiles.ranks.dtype != torch.int16 \
                or rtiles.rows.dtype != torch.int16 \
                or rtiles.step0.shape != T.runs.shape \
                or rtiles.ranks.shape[0] != rtiles.rows.shape[0] \
                or (rtiles.ranks.data_ptr() | rtiles.rows.data_ptr()) % 16:
            raise ValueError("rtiles must be segsum_rtiles of the tiles, on "
                             "x's device")
        rt = (rtiles.ranks.data_ptr(), rtiles.rows.data_ptr(),
              rtiles.step0.data_ptr())
    y = torch.empty(T.nrows, dtype=x.dtype, device=x.device)
    if T.nnz == 0:
        return y.zero_()
    part = _partials(T, x, "block_x")  # the study runs on block_x
    lib = _tiled_library(x.device.index if x.device.index is not None
                         else torch.cuda.current_device())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hprlp_tiled_segsum(
            v.code, T.nrows, T.ncols, T.strip_width, T.n_strips, T.n_groups,
            T.group_strips, T.n_chunks, T.max_block_rows, T.vals.data_ptr(),
            T.keys.data_ptr(), T.runs.data_ptr(), T.row_start.data_ptr(),
            x.data_ptr(), *rt, None if part is None else part.data_ptr(),
            y.data_ptr(), stream)
    if err != 0:
        msg = lib.hprlp_tiled_error_string(err).decode()
        raise RuntimeError(f"hprlp_tiled_segsum launch failed "
                           f"({variant_name}): {msg} ({err})")
    spmv_segsum.launches += 1
    group_sum_kernel.launches += part is not None
    return y


WRAPPERS = {"ablate": spmv_ablate, "multi_acc": spmv_multi_acc,
            "flush": spmv_flush, "segsum": spmv_segsum}
for _w in WRAPPERS.values():
    _w.launches = 0


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


def _shift(v: torch.Tensor, d: int, fill) -> torch.Tensor:
    """v moved d lanes up (d > 0, as __shfl_up_sync) or down along its last
    axis, `fill` in the lanes nothing moves into."""
    out = torch.full_like(v, fill)
    if d > 0:
        out[..., d:] = v[..., :-d]
    else:
        out[..., :d] = v[..., -d:]
    return out


def _segments(P, dev, blocks=None):
    """The warp segments of the flush study on plan P: for every segment of
    the selected blocks (all where `blocks` is None), its block and its
    index s in the block (segment s of block b covers vectors q0 + 32 s ..
    + 31, q0 = ent0[b] // 4)."""
    e0 = P.ent0.to(dev, torch.int64)
    q0, q1 = e0[:-1] // CSR_VEC, -(-e0[1:] // CSR_VEC)
    nseg = -(-(q1 - q0) // (FLUSH_SEG // CSR_VEC))
    if blocks is not None:
        nseg = torch.where(blocks, nseg, 0)
    blk = torch.repeat_interleave(torch.arange(nseg.numel(), device=dev),
                                  nseg)
    first = torch.cumsum(nseg, 0) - nseg
    return blk, torch.arange(blk.numel(), device=dev) - first[blk]


def runmerge_plain(A, x: torch.Tensor, blocks=None) -> torch.Tensor:
    """flush runmerge in plain PyTorch (any device), bit for bit: the
    kernel's order of sums on the plan (csrc/spmv_csr.cu kRunMerge).  Each
    block of short rows is cut into warp segments of 32 lanes x 4 entries;
    a lane sums its last row's entries from +0, a Hillis-Steele inclusive
    scan over the lanes (steps 1, 2, 4, 8, 16) joins rows that span lanes,
    the lane's other rows are summed from the sum flowing in from the left;
    a row inside one segment is that value, a row across segments the sum
    of its segments' partials, left to right.  Long rows: the plan's
    strided partials and tree."""
    P = plan(A, blocks)
    dev = x.device
    terms = A.vals * x[A.indices.to(torch.int64)]
    y = torch.zeros(A.nrows, dtype=x.dtype, device=dev)
    row0, ent0 = P.row0.to(dev, torch.int64), P.ent0.to(dev, torch.int64)
    short = ~((row0[1:] - row0[:-1] == 1) & (ent0[1:] - ent0[:-1] > P.cap))
    blk, s = _segments(P, dev, short)
    if blk.numel():
        r0, n = row0[blk], (row0[1:] - row0[:-1])[blk]
        e0, e1 = ent0[blk], ent0[1:][blk]
        base = (e0 // CSR_VEC + s * (FLUSH_SEG // CSR_VEC)) * CSR_VEC
        lo, hi = torch.maximum(base, e0), torch.minimum(base + FLUSH_SEG, e1)
        k = base[:, None] + torch.arange(FLUSH_SEG, device=dev)
        k = k.view(-1, 32, CSR_VEC)
        e0_, e1_ = e0[:, None, None], e1[:, None, None]
        valid = (k >= e0_) & (k < e1_)
        kc = torch.clamp(k, 0, max(A.nnz - 1, 0))
        rows = row_of_entry(A)
        key = torch.where(valid, rows[kc] - r0[:, None, None],
                          torch.where(k < e0_, -1, n[:, None, None]))
        p = torch.where(valid, terms[kc], torch.zeros((), dtype=x.dtype,
                                                       device=dev))
        lane = torch.arange(32, device=dev)
        last = key[..., -1]
        acc = torch.zeros_like(p[..., 0])
        for j in range(CSR_VEC):
            acc = torch.where(key[..., j] == last, acc + p[..., j], acc)
        S = acc
        for d in (1, 2, 4, 8, 16):
            o, kr = _shift(S, d, 0.0), _shift(last, d, -2)
            S = torch.where((lane >= d) & (kr == last), S + o, S)
        cur = torch.where((lane > 0) & (_shift(last, 1, -2) == key[..., 0]),
                          _shift(S, 1, 0.0), torch.zeros_like(S))
        closes = []  # (row in block, value, closes here)
        for j in range(CSR_VEC - 1):
            cur = cur + p[..., j]
            c = key[..., j] != key[..., j + 1]
            closes.append((key[..., j], cur, c))
            cur = torch.where(c, torch.zeros_like(cur), cur)
        closes.append((last, S, (lane == 31)
                       | (_shift(key[..., 0], -1, -2) != last)))
        n_seg = blk.numel()
        first_part = torch.zeros(n_seg, dtype=x.dtype, device=dev)
        last_part = torch.zeros(n_seg, dtype=x.dtype, device=dev)
        last_row = torch.full((n_seg,), -1, dtype=torch.int64, device=dev)
        indptr = A.indptr.to(dev, torch.int64)
        seg = torch.arange(n_seg, device=dev)[:, None].expand(-1, 32)
        for i, v, c in closes:
            c = c & (i >= 0) & (i < n[:, None])
            g, row, v = seg[c], (r0[:, None] + i)[c], v[c]
            before, after = indptr[row] < lo[g], indptr[row + 1] > hi[g]
            first_part[g[before]] = v[before]
            keep = ~before & after
            last_part[g[keep]] = v[keep]
            last_row[g[keep]] = row[keep]
            alone = ~before & ~after
            y[row[alone]] = v[alone]
        # Rows across segments: their partials, left to right.
        g = torch.nonzero(last_row >= 0).flatten()
        row, v = last_row[g], last_part[g]
        end = indptr[row + 1]
        while g.numel():
            g = g + 1
            v = v + first_part[g]
            done = end <= base[g] + FLUSH_SEG
            y[row[done]] = v[done]
            g, row, v, end = g[~done], row[~done], v[~done], end[~done]
    return long_row_sums(A, terms, P, y)


def _merge_all_plain(A, x):
    """merge_all: every warp segment's sum added into row (q0 / 32 + s) mod
    nrows (long rows' blocks too); the sum's order aside."""
    P = plan(A)
    dev = x.device
    terms = A.vals * x[A.indices.to(torch.int64)]
    b = _entry_blocks(A, P)
    q0 = P.ent0.to(dev, torch.int64)[b] // CSR_VEC
    k = torch.arange(A.nnz, device=dev)
    s = (k // CSR_VEC - q0) // (FLUSH_SEG // CSR_VEC)
    target = (q0 // (FLUSH_SEG // CSR_VEC) + s) % max(A.nrows, 1)
    return _row_sums(A, terms, target)


def _flush_plain(A, x, name):
    if name == "full":
        return csr_spmv_plain(A, x)
    if name == "runmerge":
        return runmerge_plain(A, x)
    return _merge_all_plain(A, x)


def segsum_subblocks(T: TiledMatrix) -> dict:
    """The segsum study's one-hot products on tiles T, as the kernel forms
    them: every warp run is cut into steps of SEG_STEP and sub-blocks of
    SEG_SUB entries from its start; an entry's rank is the number of
    distinct rows before it in its sub-block.  Returns (int64, on T's
    device) "sub" (the sub-block of each tile position, numbered run by
    run), "pos" (its place in the sub-block), "rank", "row" (its row;
    padding gets nrows), "rib" (its row in its chunk, SENTINEL_ROW for
    padding), "step_row" (the row of its warp step's first entry), "run"
    (its warp run), "at" (its place in the run) and "row_of_rank" (n_sub,
    SEG_SUB): the row each rank sums into (nrows where no entry has the
    rank)."""
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
    step_first = T.runs.to(torch.int64)[run] + at // SEG_STEP * SEG_STEP
    return {"sub": sub, "pos": pos, "rank": rank, "row": row, "rib": rib,
            "row_of_rank": row_of_rank, "run": run, "at": at,
            "step_row": row[step_first]}


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
    """The segsum variants on A's tiles (segsum_tiles where A has none):
    full's one-hot products; every other variant's per-entry terms (bf16
    hi + lo, bf16 hi, TF32 hi + lo) added into the row its rank maps to
    (mm_fused: the step's first row plus the row's distance from it,
    clamped to 15), in another order than the tensor cores'."""
    T = _segsum_tiles_of(A, tiles)
    if name == "full":
        return segsum_onehot_plain(T, x)
    sb = segsum_subblocks(T)
    col = T.coo[2][torch.argsort(T.coo[0])]  # column of each tile position
    p = T.vals * x[torch.clamp(col, max=T.ncols - 1)]
    if name == "mm_fused":
        hi = _tf32(p)
        per_entry = hi + _tf32(p - hi)
    elif name == "mm_precomp":
        hi = _bf16(p)
        per_entry = hi + _bf16(p - hi)
    else:  # mm_hi1
        per_entry = _bf16(p)
    rows = sb["row"]
    if name == "mm_fused":
        first = sb["step_row"]
        rows = torch.where(rows == T.nrows, rows,
                           first + torch.clamp(rows - first,
                                               max=SEG_RANKS - 1))
    y = torch.zeros(T.nrows + 1, dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, per_entry)[:T.nrows]


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
