"""The SpMV variant studies on the CPU: the plain versions of
hprlp_tpu_torch/ops/spmv_variants.py (the kernels themselves run on the
card, tests/test_torch_spmv_variants_gpu.py), the study path's helpers,
and parity with the Pallas studies of benchmarks/ they replace.

- Every variant's plain version against a loop-by-loop numpy reading of
  its definition (the notes of csrc/spmv_csr.cu and csrc/spmv_tiled.cu),
  on the CSR cases of the card's tests: empty rows, a row longer than a
  flush segment and one longer than the row-block plan's window, rows
  split across flush segments and segsum steps, blocks of 256 rows,
  several x windows.  The ablate, multi_acc and flush families run on the
  row-block plan: the definitions of the exact ones (and of no_flush,
  dma_only, no_gather, one_gather) repeat the kernel's f32 arithmetic on
  the plan -- runmerge's segmented warp scan included -- and their plain
  versions give the same bits; merge_all's segments are the plan's.  The
  segsum family runs on the tiles: its definitions read the tiles
  position by position (mm_fused's ranks against each warp step's first
  row).
- The exact variants against scipy's A @ x.
- The exact variants against the JAX study kernel they translate, run in
  interpret mode on LaneELL tiles of the same matrix: prof_lane_ablate
  full, prof_dual_acc n_acc 1/2/4 (outputs summed as its spmv_loop does),
  prof_flush_variants full/runmerge, prof_kernel_variants full and
  mm_precomp with the identity rank (its segment sum then reduces to the
  production kernel's flush; mm_precomp's R tiles the one-hot of that
  rank); segsum runs on the main path's tiles (csrc/spmv_tiled.cu, SEG),
  full's one-hot products are held to a numpy segment sum, and
  mm_precomp's R (segsum_rtiles) to the sub-blocks' ranks and rows.  The
  timing-only variants have no JAX comparison: their TPU
  counterparts compute layout-specific values (LaneELL slots, flushes
  into 128-row windows, clamped ranks within a tile) that have no meaning
  for a CSR matrix.

Tolerance: bitwise for the variants on the row-block plan against their
definitions (merge_all aside); else max abs error <= 1e-5 * max(1,
max|y|) (1e-4 for the two-term bf16 mm_precomp against A @ x): the sums
run in other orders.
"""

import ast
import dataclasses
import importlib
import os

import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.spmv import (CSR_BLOCK, csr_cap, csr_spmv_plain,
                                      row_blocks)
from hprlp_tpu_torch.ops.spmv_variants import (FLUSH_SEG, SEG_RANKS,
                                               SEG_SMEM_BYTES, SEG_STEP,
                                               SEG_SUB, VARIANTS, WINDOW,
                                               WRAPPERS, plain,
                                               segsum_onehot_plain,
                                               segsum_rtiles,
                                               segsum_subblocks, segsum_tiles,
                                               variant_spmv)
from hprlp_tpu_torch.ops.tiles import SENTINEL_ROW, WARPS, build_tiles
from hprlp_tpu_torch.prof import study, timing
from test_torch_spmv_variants_gpu import CASES, FAMILY_VARIANTS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = [(f, v) for f, v in FAMILY_VARIANTS if VARIANTS[f][v].exact]
# The variants that run on the CSR kernel's row-block plan and give the
# bits of a numpy reading of it.
ON_PLAN = [(f, v) for f, v in FAMILY_VARIANTS
           if f in ("ablate", "multi_acc")
           or (f, v) in (("flush", "full"), ("flush", "runmerge"))]


def _case(case):
    A = CASES[case]().tocsr()
    A.sort_indices()
    M = csr_from_coo(*_coo(A), A.shape[0], A.shape[1], torch.float32, "cpu")
    x = np.random.default_rng(11).normal(size=A.shape[1]).astype(np.float32)
    return A, M, x


def _coo(A):
    C = A.tocoo()
    return C.row, C.col, C.data


def _tf32(v):
    b = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _bf16(v):
    b = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _plan_definition(name, A, x, P):
    """What a variant on the row-block plan P computes, in the kernel's f32
    arithmetic and order, block by block and entry by entry (CSR A, f32
    x): every term rounded; a short row summed from 0 in CSR order, entry
    j into accumulator j % n_acc, the accumulators added pairwise; a long
    row's block in CSR_BLOCK strided partials and a tree; no_flush's
    thread t summing the entries of its 4-entry vectors (q - q0) % 256 ==
    t and storing to row r0 + t."""
    nrows, ncols = A.shape
    indptr, idx = A.indptr, A.indices
    vals = A.data.astype(np.float32)
    mask = (1 << (max(ncols, 1).bit_length() - 1)) - 1
    win = min(WINDOW, mask + 1)
    nwin = max(ncols // win, 1)
    n_acc = int(name.split("=")[1]) if name.startswith("n_acc=") else 1
    row0, ent0 = P.row0.numpy(), P.ent0.numpy()
    y = np.zeros(nrows, np.float32)
    for b in range(len(row0) - 1):
        r0, r1, e0, e1 = row0[b], row0[b + 1], ent0[b], ent0[b + 1]

        def term(k):
            c = idx[k]
            if name == "dma_only":
                return vals[k] + np.float32(c)
            if name == "no_gather":
                return vals[k] * x[k & mask]
            if name == "one_gather":
                return vals[k] * x[(b % nwin) * win + (c & (win - 1))]
            return vals[k] * x[c]

        if r1 - r0 == 1 and e1 - e0 > P.cap:
            part = np.zeros(CSR_BLOCK, np.float32)
            for k in range(e0, e1):
                part[(k - e0) % CSR_BLOCK] += term(k)
            w = CSR_BLOCK // 2
            while w and name != "no_flush":
                part[:w] = part[:w] + part[w:2 * w]
                w //= 2
            y[r0] = part[0]
        elif name == "no_flush":
            part = np.zeros(CSR_BLOCK, np.float32)
            for k in range(e0, e1):
                part[(k // 4 - e0 // 4) % CSR_BLOCK] += term(k)
            y[r0:r1] = part[:r1 - r0]
        else:
            for r in range(r0, r1):
                acc = np.zeros(n_acc, np.float32)
                for k in range(indptr[r], indptr[r + 1]):
                    acc[(k - indptr[r]) % n_acc] += term(k)
                while len(acc) > 1:
                    acc = acc[0::2] + acc[1::2]
                y[r] = acc[0]
    return y


def _runmerge_definition(A, x, P):
    """flush runmerge on plan P, lane by lane as csrc/spmv_csr.cu kRunMerge
    runs it: a block of short rows in warp segments of 32 lanes x 4
    entries from its first aligned vector; each lane's last row summed
    from 0, a Hillis-Steele scan over the lanes joining equal last rows,
    the lane's other rows summed from what flows in from the left; a row
    inside a segment stored, a row across segments the sum of its
    partials left to right; empty rows 0; a long row's block as full's."""
    indptr, idx = A.indptr, A.indices
    terms = (A.data.astype(np.float32) * x[idx]).astype(np.float32)
    row_of = np.repeat(np.arange(A.shape[0]), np.diff(indptr))
    y = _plan_definition("full", A, x, P)  # long rows; the rest below
    row0, ent0 = P.row0.numpy(), P.ent0.numpy()
    for b in range(len(row0) - 1):
        r0, r1, e0, e1 = (int(v) for v in (row0[b], row0[b + 1], ent0[b],
                                            ent0[b + 1]))
        if r1 - r0 == 1 and e1 - e0 > P.cap:
            continue
        n = r1 - r0
        y[r0:r1] = 0
        q0, q1 = e0 // 4, -(-e1 // 4)
        first, last = {}, {}
        for s in range(-(-(q1 - q0) // 32)):
            base = (q0 + 32 * s) * 4
            lo, hi = max(base, e0), min(base + FLUSH_SEG, e1)
            key = np.empty((32, 4), np.int64)
            p = np.zeros((32, 4), np.float32)
            for lane in range(32):
                for j in range(4):
                    k = base + 4 * lane + j
                    if k < e0:
                        key[lane, j] = -1
                    elif k >= e1:
                        key[lane, j] = n
                    else:
                        key[lane, j] = row_of[k] - r0
                        p[lane, j] = terms[k]
            S = np.zeros(32, np.float32)
            for lane in range(32):
                for j in range(4):
                    if key[lane, j] == key[lane, 3]:
                        S[lane] = S[lane] + p[lane, j]
            for d in (1, 2, 4, 8, 16):
                S = np.array([S[i] + S[i - d] if i >= d and key[i - d, 3]
                              == key[i, 3] else S[i] for i in range(32)],
                             np.float32)
            closes = []
            for lane in range(32):
                cur = (S[lane - 1] if lane and key[lane - 1, 3] == key[lane, 0]
                       else np.float32(0))
                for j in range(3):
                    cur = np.float32(cur + p[lane, j])
                    if key[lane, j] != key[lane, j + 1]:
                        closes.append((key[lane, j], cur))
                        cur = np.float32(0)
                if lane == 31 or key[lane + 1, 0] != key[lane, 3]:
                    closes.append((key[lane, 3], S[lane]))
            for i, v in closes:
                if not 0 <= i < n:
                    continue
                row = r0 + i
                if indptr[row] < lo:
                    first[s] = v
                elif indptr[row + 1] > hi:
                    last[s] = (row, v)
                else:
                    y[row] = v
        for s, (row, v) in last.items():
            s2 = s
            while True:
                s2 += 1
                v = np.float32(v + first[s2])
                if indptr[row + 1] <= (q0 + 32 * (s2 + 1)) * 4:
                    break
            y[row] = v
    return y


def _tile_positions(T):
    """Each tile position of T as (run, row, col): padding has row -1."""
    runs = T.runs.numpy().astype(np.int64)
    keys = T.keys.numpy().astype(np.int64) & 0xFFFFFFFF
    row_start = T.row_start.numpy()
    out = []
    for run in range(len(runs) - 1):
        block, strip_l = run // (T.group_strips * WARPS), run % T.group_strips
        chunk = block % T.n_chunks
        strip = block // T.n_chunks * T.group_strips + strip_l
        for i in range(runs[run], runs[run + 1]):
            rib, c = keys[i] >> 16, keys[i] & 0xFFFF
            out.append((run, -1 if rib == SENTINEL_ROW
                        else row_start[chunk] + rib, strip * T.strip_width + c))
    return out


def _definition(family, name, A, x, M, T=None):
    """What the variant computes, entry by entry (CSR A, f32 x; M the same
    matrix as the port holds it): the flush family on M's row-block plan,
    the segsum family on tiles T (segsum_tiles(M) where not given)."""
    nrows, ncols = A.shape
    y = np.zeros(nrows)
    if family == "flush":  # merge_all: each warp segment into one row
        P = row_blocks(M)
        row0, ent0 = P.row0.numpy(), P.ent0.numpy()
        for b in range(len(row0) - 1):
            q0 = ent0[b] // 4
            for k in range(ent0[b], ent0[b + 1]):
                s = (k // 4 - q0) // (FLUSH_SEG // 4)
                y[(q0 // (FLUSH_SEG // 4) + s) % nrows] += float(
                    np.float32(A.data[k] * x[A.indices[k]]))
        return y
    T = segsum_tiles(M) if T is None else T
    vals, runs = T.vals.numpy(), T.runs.numpy()
    pos = _tile_positions(T)
    for i, (run, r, c) in enumerate(pos):
        if r < 0:
            continue
        p = np.float32(vals[i] * x[c])
        target, add = r, float(p)  # full: hi + mid + lo, exact
        if name == "mm_fused":
            hi = _tf32(p)
            add = float(hi) + float(_tf32(p - hi))
            first = pos[runs[run] + (i - runs[run]) // SEG_STEP * SEG_STEP][1]
            target = first + min(r - first, SEG_RANKS - 1)
        elif name == "mm_precomp":
            hi = _bf16(p)
            add = float(hi) + float(_bf16(p - hi))
        elif name == "mm_hi1":
            add = float(_bf16(p))
        y[target] += add
    return y


def _assert_close(y, y_ref, tol):
    scale = max(1.0, float(np.abs(y_ref).max(initial=0.0)))
    assert np.abs(np.asarray(y, np.float64) - y_ref).max(initial=0.0) \
        <= tol * scale


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("family,name", FAMILY_VARIANTS,
                         ids=[f"{f}-{v}" for f, v in FAMILY_VARIANTS])
def test_plain_variant_matches_its_definition(family, name, case):
    A, M, x = _case(case)
    y = plain(family, M, torch.as_tensor(x), name)
    assert y.dtype == torch.float32 and y.shape == (A.shape[0],)
    if (family, name) == ("flush", "runmerge"):
        np.testing.assert_array_equal(
            y.numpy(), _runmerge_definition(A, x, row_blocks(M)))
    elif (family, name) in ON_PLAN:
        np.testing.assert_array_equal(
            y.numpy(), _plan_definition(name, A, x, row_blocks(M)))
    else:
        _assert_close(y.numpy(), _definition(family, name, A, x, M), 1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_variants_are_csr_spmv_plain(case):
    """ablate full, multi_acc n_acc=1 and flush full are csr_spmv's launch:
    their plain versions give csr_spmv_plain's bits; so does one on the
    matrix's own plan, which the study matrices carry."""
    _, M, x = _case(case)
    x = torch.as_tensor(x)
    y = csr_spmv_plain(M, x)
    for family, name in (("ablate", "full"), ("multi_acc", "n_acc=1"),
                         ("flush", "full")):
        assert torch.equal(plain(family, M, x, name), y)
    G = dataclasses.replace(M, blocks=row_blocks(M))
    assert torch.equal(plain("ablate", G, x, "full"), y)


def test_cases_reach_the_plans_edges():
    """The cases hold a row longer than the f32 window (a block alone), a
    block of 256 rows and runs of empty rows within blocks."""
    edges = set()
    for case in CASES:
        A, M, _ = _case(case)
        P = row_blocks(M)
        rows = (P.row0[1:] - P.row0[:-1]).numpy()
        ents = (P.ent0[1:] - P.ent0[:-1]).numpy()
        edges |= {"long"} if ((rows == 1) & (ents > csr_cap(
            torch.float32))).any() else set()
        edges |= {"256"} if (rows == CSR_BLOCK).any() else set()
        empty = np.diff(A.indptr) == 0
        edges |= {"empty"} if (empty[1:] & empty[:-1]).any() else set()
    assert edges == {"long", "256", "empty"}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("family,name", EXACT,
                         ids=[f"{f}-{v}" for f, v in EXACT])
def test_exact_variant_matches_scipy(family, name, case):
    A, M, x = _case(case)
    y = variant_spmv(family, M, torch.as_tensor(x), name)
    _assert_close(y.numpy(), A @ x.astype(np.float64),
                  VARIANTS[family][name].tol)


SEGSUM = [v for f, v in FAMILY_VARIANTS if f == "segsum"]


@pytest.mark.parametrize("case", ["empty_rows", "one_per_row", "tpr8"])
@pytest.mark.parametrize("name", SEGSUM)
def test_segsum_plain_on_strip_groups(name, case):
    """The segsum variants on tiles of two strip groups and narrow strips
    (more runs, each group's partial y): the plain version, given the
    tiles, against the definition read from the same tiles."""
    A, M, x = _case(case)
    T = build_tiles(M, strip_width=128, block_rows=300, strip_groups=2)
    assert T.n_groups == 2
    assert T.smem_bytes + SEG_SMEM_BYTES[name] <= 232448
    G = M.with_tiles(T)
    y = plain("segsum", G, torch.as_tensor(x), name)
    _assert_close(y.numpy(), _definition("segsum", name, A, x, M, T), 1e-5)


def test_segsum_rtiles_hold_the_fragment_order_of_r():
    """Unpacking mm_precomp's R as the kernel's lanes read it (lane 4g + t:
    word t of each of a step's 8 sub-blocks, the ranks of the sub-block's
    entries 4t .. 4t + 3, which are the mma's k = 2t, 2t + 1, 2t + 8, 2t +
    9; rows g and g + 8 of R) gives the one-hot R of every 16-entry
    sub-block of segsum_subblocks, its steps numbered run by run; the row
    table maps ranks g and g + 8 to the row (in its chunk) of their
    entries, the padding row where none has the rank.  Cases with
    sub-blocks of 16 ranks and runs of empty rows."""
    for case in ("one_per_row", "empty_rows"):
        _, M, _ = _case(case)
        T = segsum_tiles(M)
        rt = segsum_rtiles(T)
        sb = {k: v.numpy() for k, v in segsum_subblocks(T).items()}
        runs = T.runs.numpy().astype(np.int64)
        steps = -(-np.diff(runs) // SEG_STEP)
        step0 = np.concatenate([[0], np.cumsum(steps)])
        n_steps = int(step0[-1])
        assert rt.ranks.shape == (n_steps, 4, 8)
        assert rt.rows.shape == (n_steps, 8, 8, 2)
        np.testing.assert_array_equal(rt.step0.numpy(), step0)
        assert rt.nbytes == n_steps * 320 + 4 * len(runs)
        words = rt.ranks.numpy().view(np.uint16)
        R = np.zeros((n_steps, 8, SEG_SUB, SEG_SUB))
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j, k in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
                rank = (words[:, t, :] >> (4 * j)) & 15
                for row in (g, g + 8):
                    R[:, :, row, k] = np.maximum(R[:, :, row, k],
                                                 rank == row)
        expect = np.zeros_like(R)
        expect[:, :, 0, :] = 1  # positions without an entry: rank 0
        want = np.full((n_steps, 8, 8, 2), SENTINEL_ROW)
        k_of = np.array([0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14,
                         15])  # entry 4t + j -> k
        for run, at, pos, rank, rib in zip(sb["run"], sb["at"], sb["pos"],
                                           sb["rank"], sb["rib"]):
            st, q = step0[run] + at // SEG_STEP, at % SEG_STEP // SEG_SUB
            expect[st, q, :, k_of[pos]] = 0
            expect[st, q, rank, k_of[pos]] = 1
            want[st, rank % 8, q, rank // 8] = rib
        np.testing.assert_array_equal(R, expect)
        np.testing.assert_array_equal(rt.rows.numpy().view(np.uint16), want)
        if case == "one_per_row":  # a sub-block of 16 rows of one entry
            assert (sb["rank"] == SEG_SUB - 1).any()


@pytest.mark.parametrize("layout", ["segsum", "narrow"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_segsum_onehot_products_are_numpy_segment_sums(case, layout):
    """segsum full's construction on the tiles, read position by position:
    every warp run cut into SEG_STEP-entry steps and SEG_SUB-entry
    sub-blocks; an entry's rank counts the distinct rows before it in its
    sub-block (< 16); R P (R one-hot by rank, P the exact bf16 terms of
    the products) gives, for each rank, the numpy sum of its entries'
    products, and rank r maps to the row of its entries.  Then the plain
    version against A @ x.  Tiles: segsum_tiles' and narrow strips and
    row chunks (many runs, padding in sub-blocks)."""
    A, M, x = _case(case)
    T = (segsum_tiles(M) if layout == "segsum"
         else build_tiles(M, strip_width=64, block_rows=40))
    sb = segsum_subblocks(T)
    order, row_o, col_o = (v.numpy() for v in T.coo)
    col = np.empty_like(col_o)
    col[order] = col_o
    vals = T.vals.numpy()
    runs = T.runs.numpy().astype(np.int64)
    sub, pos, rank, row = (sb[k].numpy() for k in ("sub", "pos", "rank",
                                                   "row"))
    row_of_rank = sb["row_of_rank"].numpy()
    assert SEG_STEP % SEG_SUB == 0 and rank.max(initial=0) < SEG_SUB
    sums = {}
    for r in range(len(runs) - 1):  # each warp run, from its start
        for i in range(runs[r], runs[r + 1]):
            at = i - runs[r]
            assert pos[i] == at % SEG_SUB
            same = sub[runs[r] + at // SEG_SUB * SEG_SUB]
            assert sub[i] == same
            first = runs[r] + at // SEG_SUB * SEG_SUB
            rows_before = set(row[first:i])
            assert rank[i] == len(rows_before - {row[i]})
            assert row_of_rank[sub[i], rank[i]] == row[i]
            p = np.float32(vals[i] * x[min(col[i], A.shape[1] - 1)])
            sums[sub[i], rank[i]] = sums.get((sub[i], rank[i]), 0.0) + float(p)
    y = np.zeros(A.shape[0] + 1)
    for (s_, r_), v in sums.items():
        y[row_of_rank[s_, r_]] += v
    _assert_close(segsum_onehot_plain(T, torch.as_tensor(x)).numpy(),
                  y[:A.shape[0]], 1e-5)
    _assert_close(y[:A.shape[0]], A @ x.astype(np.float64), 1e-5)


@pytest.mark.parametrize("family", sorted(WRAPPERS))
def test_variant_wrappers_refuse_cpu_tensors(family):
    """No hidden fallback: a wrapper takes CUDA tensors only; the CPU goes
    through variant_spmv to the plain version, launching nothing."""
    _, M, x = _case("tiny")
    name = next(iter(VARIANTS[family]))
    with pytest.raises(ValueError, match="CUDA"):
        WRAPPERS[family](M, torch.as_tensor(x), name)
    before = WRAPPERS[family].launches
    variant_spmv(family, M, torch.as_tensor(x), name)
    assert WRAPPERS[family].launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        variant_spmv(family, M, torch.ones(130, device="meta"), name)
    with pytest.raises(ValueError, match="unknown variant"):
        plain(family, M, torch.as_tensor(x), "no_such_variant")


def _study_main_variants(path):
    """The variant tuple the JAX study's main() loops over."""
    with open(path) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For)
                and isinstance(n.iter, ast.Tuple)
                and all(isinstance(e, ast.Constant) for e in n.iter.elts))
    return tuple(ast.literal_eval(loop.iter))


@pytest.mark.parametrize("module,study,family", [
    ("prof_lane_ablate", "prof_lane_ablate.py", "ablate"),
    ("prof_dual_acc", "prof_dual_acc.py", "multi_acc"),
    ("prof_flush_variants", "prof_flush_variants.py", "flush"),
    ("prof_kernel_variants", "prof_kernel_variants.py", "segsum"),
])
def test_port_studies_run_the_jax_variant_lists(module, study, family):
    mod = importlib.import_module(f"hprlp_tpu_torch.prof.{module}")
    jax_variants = _study_main_variants(os.path.join(ROOT, "benchmarks",
                                                     study))
    names = [VARIANTS[family][v].translates.split()[-1]
             for v in mod.VARIANTS]
    assert names == [str(v) if isinstance(v, str) else f"n_acc={v}"
                     for v in jax_variants]
    assert mod.FAMILY == family and set(mod.VARIANTS) == set(VARIANTS[family])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


def test_spmv_byte_model_and_bound():
    """Values, indices, indptr, x and y, each once (the bench LP's A:
    11,533,692 bytes in f32, 17,562,680 in f64), over 3.35 TB/s."""
    class Shape:
        nnz, nrows, ncols = 1310639, 65536, 131072

    assert timing.spmv_bytes(Shape, torch.float32) == 11_533_692
    assert timing.spmv_bytes(Shape, torch.float64) == 17_562_680
    ms, by = timing.spmv_bound(Shape, torch.float32)
    assert by == "bytes" and ms == pytest.approx(11_533_692 / 3.35e12 * 1e3)
    # ablate dma_only reads no x: its bytes are the rest.
    assert study.variant_bound("ablate", "full", Shape) == (11_533_692, ms,
                                                            "bytes")
    nbytes, ms, by = study.variant_bound("ablate", "dma_only", Shape)
    assert nbytes == 11_533_692 - 131072 * 4 and by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    # mm_precomp also reads its R: 64 B of ranks and 256 B of rows per
    # 128-entry warp step, 4 B per run; no other variant reads more.
    from hprlp_tpu_torch.prof.problems import random_lp

    M = study.device_matrices(random_lp(300, 500, 4, seed=1),
                              device="cpu")["A"]
    base = timing.spmv_bytes(M, torch.float32)
    rt = segsum_rtiles(M.tiles)
    nbytes, ms, by = study.variant_bound("segsum", "mm_precomp", M)
    assert nbytes == base + rt.nbytes > base and by == "bytes"
    assert rt.nbytes == 320 * rt.rows.shape[0] + 4 * M.tiles.runs.numel()
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    for family, name in (("segsum", "full"), ("segsum", "mm_hi1"),
                         ("segsum", "mm_fused"), ("flush", "runmerge"),
                         ("flush", "merge_all")):
        assert study.variant_bound(family, name, M)[0] == base


def test_study_matrices_carry_the_plan_and_the_tiles():
    """The studies' A and A^T are on the "gather" backend (the plan the CSR
    kernel's variants need) and carry segsum full's tiles."""
    from hprlp_tpu_torch.prof.problems import random_lp

    mats = study.device_matrices(random_lp(300, 500, 4, seed=1),
                                 device="cpu")
    assert sorted(mats) == ["A", "AT"]
    for M in mats.values():
        assert M.blocks is not None and M.tiles is not None
        assert M.blocks.cap == csr_cap(torch.float32)
        assert torch.equal(M.blocks.row0, row_blocks(M).row0)
        x = study.study_x(M)
        assert torch.equal(variant_spmv("ablate", M, x, "full"),
                           csr_spmv_plain(M, x))


# ------------------------------------------------ parity with the JAX studies

@pytest.fixture(scope="module")
def jax_studies(tmp_path_factory):
    """The four benchmarks/prof_*.py modules.  Each sets a persistent
    compile cache when imported: point it into a temporary directory, and
    put the jax config of the test run back afterwards."""
    import jax

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    mp = pytest.MonkeyPatch()
    mp.setenv("JAX_COMPILATION_CACHE_DIR",
              str(tmp_path_factory.mktemp("jax_cache")))
    mp.syspath_prepend(os.path.join(ROOT, "benchmarks"))
    mp.syspath_prepend(ROOT)
    try:
        yield {name: importlib.import_module(name) for name in (
            "prof_lane_ablate", "prof_dual_acc", "prof_flush_variants",
            "prof_kernel_variants")}
    finally:
        mp.undo()
        for k, v in saved.items():
            jax.config.update(k, v)


def _run_jax_study(module, kernel_arg, x, p, extra=None, n_out=1,
                   round_g=True):
    """pl.pallas_call(module.make_kernel(arg)) with the script's grid spec,
    in interpret mode, on packed LaneELL tiles; returns y = y2[:G]."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from hprlp_tpu.ops.lane_ell import CHUNK_SUB, LANES

    C = p["idx2"].shape[0]
    n_win = -(-x.shape[0] // WINDOW)
    x3 = np.pad(x, (0, n_win * WINDOW - x.shape[0])).reshape(
        n_win, LANES, LANES)
    g_real = p["G"]
    g_alloc = (-(-max(g_real, LANES) // LANES) * LANES if round_g
               else max(g_real, LANES))
    by_chunk = lambda c, w, g: (c, 0, 0)  # noqa: E731
    in_specs = [
        pl.BlockSpec((1, LANES, LANES), lambda c, w, g: (w[c], 0, 0),
                     memory_space=pltpu.VMEM),
        pl.BlockSpec((1, LANES, CHUNK_SUB), by_chunk, memory_space=pltpu.VMEM),
        pl.BlockSpec((1, CHUNK_SUB, LANES), by_chunk, memory_space=pltpu.VMEM),
        pl.BlockSpec((1, CHUNK_SUB, LANES), by_chunk, memory_space=pltpu.VMEM),
    ]
    inputs = [p["wid"], p["gbase"], x3, p["idx1t"], p["idx2"], p["vals"]]
    for arr in extra or ():
        in_specs.append(pl.BlockSpec((1,) + arr.shape[1:], by_chunk,
                                     memory_space=pltpu.VMEM))
        inputs.append(arr)
    out = pl.BlockSpec((g_alloc, LANES), lambda c, w, g: (0, 0),
                       memory_space=pltpu.VMEM)
    shape = jax.ShapeDtypeStruct((g_alloc, LANES), jnp.float32)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(C,), in_specs=in_specs,
        out_specs=out if n_out == 1 else (out,) * n_out,
        scratch_shapes=[pltpu.VMEM((CHUNK_SUB, LANES), jnp.float32)])
    with jax.enable_x64(False):
        y2 = pl.pallas_call(
            module.make_kernel(kernel_arg), grid_spec=grid_spec,
            out_shape=shape if n_out == 1 else (shape,) * n_out,
            interpret=True)(*[jnp.asarray(a) for a in inputs])
    if n_out > 1:
        y2 = sum(y2[1:], y2[0])
    return np.asarray(y2[:g_real], np.float64).reshape(-1)


PARITY = [
    ("prof_lane_ablate", "full", "ablate", "full"),
    ("prof_dual_acc", 1, "multi_acc", "n_acc=1"),
    ("prof_dual_acc", 2, "multi_acc", "n_acc=2"),
    ("prof_dual_acc", 4, "multi_acc", "n_acc=4"),
    ("prof_flush_variants", "full", "flush", "full"),
    ("prof_flush_variants", "runmerge", "flush", "runmerge"),
    ("prof_kernel_variants", "full", "segsum", "full"),
    ("prof_kernel_variants", "mm_precomp", "segsum", "mm_precomp"),
]


@pytest.mark.parametrize("study,arg,family,name", PARITY,
                         ids=[f"{s}-{a}" for s, a, _, _ in PARITY])
def test_exact_variant_matches_jax_study(jax_studies, study, arg, family,
                                         name):
    from hprlp_tpu.ops.lane_ell import CHUNK_SUB, LANES, SUBBLOCKS
    from hprlp_tpu.ops.lane_ell import schedule_lane_ell
    from hprlp_tpu.ops.pallas_spmv import pack_tiles

    rng = np.random.default_rng(1)
    A = sp.random(900, 1100, density=0.01, random_state=rng,
                  data_rvs=lambda s: rng.normal(size=s)).tocoo()
    m_pad, n_pad = 1024, 1280
    x = np.random.default_rng(0).normal(size=n_pad).astype(np.float32)
    p = pack_tiles(schedule_lane_ell(A.row.astype(np.int64),
                                     A.col.astype(np.int64), A.data,
                                     m_pad, n_pad), n_pad, np.float32)
    extra, n_out = None, 1
    if study == "prof_kernel_variants":
        C = p["idx2"].shape[0]
        rank = np.broadcast_to(np.tile(np.arange(LANES, dtype=np.int32),
                                       SUBBLOCKS), (C, 8, CHUNK_SUB))
        # R tiles: the one-hot of the rank (mm_precomp reads them as bf16).
        rtiles = (rank[:, :1, :] == np.arange(LANES)[None, :, None])
        extra = [np.ascontiguousarray(rank),
                 rtiles.astype(ml_dtypes.bfloat16)]
    elif study == "prof_dual_acc":
        n_out = arg
    y_jax = _run_jax_study(jax_studies[study], arg, x, p, extra, n_out,
                           round_g=study != "prof_kernel_variants")
    M = csr_from_coo(A.row, A.col, A.data, m_pad, n_pad, torch.float32, "cpu")
    y = variant_spmv(family, M, torch.as_tensor(x), name).numpy()
    y_ref = np.zeros(m_pad)
    y_ref[:900] = A.tocsr() @ x[:1100].astype(np.float64)
    tol = VARIANTS[family][name].tol
    _assert_close(y_jax, y_ref, tol)
    _assert_close(y, y_jax, tol)
