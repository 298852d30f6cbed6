"""The SpMV variant studies on the CPU: the plain versions of
hprlp_tpu_torch/ops/spmv_variants.py (the kernels themselves run on the
card, tests/test_torch_spmv_variants_gpu.py), the study path's helpers,
and parity with the Pallas studies of benchmarks/ they replace.

- Every variant's plain version against a loop-by-loop numpy reading of
  its definition (the notes of csrc/spmv_csr.cu and csrc/spmv_variants.cu),
  on the CSR cases of the card's tests: empty rows, a row longer than a
  warp run and one longer than the row-block plan's window, rows split
  across warp runs and segsum tiles, blocks of 256 rows, several x
  windows.  The ablate and multi_acc families (and flush full) run on the
  row-block plan: their definitions repeat the kernel's f32 arithmetic on
  the plan, and their plain versions give the same bits.
- The exact variants against scipy's A @ x.
- The exact variants against the JAX study kernel they translate, run in
  interpret mode on LaneELL tiles of the same matrix: prof_lane_ablate
  full, prof_dual_acc n_acc 1/2/4 (outputs summed as its spmv_loop does),
  prof_flush_variants full/runmerge, prof_kernel_variants full with the
  identity rank (its segment sum then reduces to the production kernel's
  flush); segsum full runs on the main path's tiles (csrc/spmv_tiled.cu,
  ONEHOT), and its one-hot products are held to a numpy segment sum.  The timing-only variants have no JAX comparison: their TPU
  counterparts compute layout-specific values (LaneELL slots, flushes
  into 128-row windows, clamped ranks within a tile) that have no meaning
  for a CSR matrix.

Tolerance: bitwise for the variants on the row-block plan against their
definitions; else max abs error <= 1e-5 * max(1, max|y|) (1e-4 for the
two-term bf16 mm_precomp against A @ x): the sums run in other orders.
"""

import ast
import dataclasses
import importlib
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.spmv import (CSR_BLOCK, csr_cap, csr_spmv_plain,
                                      row_blocks)
from hprlp_tpu_torch.ops.spmv_variants import (RANKS, RUN, SEG_STEP,
                                               SEG_SUB, SUB, TILE, VARIANTS,
                                               WINDOW, WRAPPERS, plain,
                                               segsum_onehot_plain,
                                               segsum_rtiles,
                                               segsum_subblocks, segsum_tiles,
                                               variant_spmv)
from hprlp_tpu_torch.ops.tiles import build_tiles
from hprlp_tpu_torch.prof import study, timing
from test_torch_spmv_variants_gpu import CASES, FAMILY_VARIANTS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = [(f, v) for f, v in FAMILY_VARIANTS if VARIANTS[f][v].exact]
# The variants that run on the CSR kernel's row-block plan.
ON_PLAN = [(f, v) for f, v in FAMILY_VARIANTS
           if f in ("ablate", "multi_acc") or (f, v) == ("flush", "full")]


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


def _definition(family, name, A, x):
    """What the variant computes, entry by entry (CSR A, f32 x)."""
    nrows, ncols = A.shape
    indptr, idx = A.indptr, A.indices
    vals = A.data.astype(np.float32)
    y = np.zeros(nrows)
    row_of = np.repeat(np.arange(nrows), np.diff(indptr))
    for r in range(nrows):
        for k in range(indptr[r], indptr[r + 1]):
            c = idx[k]
            p = np.float32(vals[k] * x[c])
            target, add = r, float(p)
            if name == "merge_all":
                target = (k // RUN) % nrows
            elif family == "segsum" and name == "full":
                add = float(p)  # hi + mid + lo, exact in three bf16 terms
            elif name == "mm_fused":
                hi = _tf32(p)
                add = float(hi) + float(_tf32(p - hi))
                first = row_of[k // TILE * TILE]
                target = first + min(r - first, RANKS - 1)
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
    if (family, name) in ON_PLAN:
        np.testing.assert_array_equal(
            y.numpy(), _plan_definition(name, A, x, row_blocks(M)))
    else:
        _assert_close(y.numpy(), _definition(family, name, A, x), 1e-5)


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


def test_segsum_rtiles_hold_the_fragment_order_of_r():
    """Unpacking the tiles as mma m16n8k8 reads them (lane 4g + t: rows g
    and g + 8, columns 2t and 2t + 1) gives the one-hot R of every 8-entry
    sub-block: R[r][k] = 1 where entry k lies r < 16 rows past the
    sub-block's first entry."""
    A, M, _ = _case("empty_rows")
    tiles = segsum_rtiles(M).numpy().view(np.uint32)
    nsub = -(-A.nnz // SUB)
    assert tiles.shape == (nsub, 32, 2)
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    R = np.zeros((nsub, RANKS, SUB))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, rank in ((0, g), (1, g + 8)):
            for half, col in ((0, 2 * t), (1, 2 * t + 1)):
                bits = (tiles[:, lane, reg] >> (16 * half)) & 0xFFFF
                assert set(np.unique(bits)) <= {0, 0x3F80}
                R[:, rank, col] = bits == 0x3F80
    expect = np.zeros_like(R)
    for k in range(A.nnz):
        rank = rows[k] - rows[k // SUB * SUB]
        if rank < RANKS:
            expect[k // SUB, rank, k % SUB] = 1
    np.testing.assert_array_equal(R, expect)
    assert (expect.sum(axis=(1, 2)) < SUB).any()  # ranks >= 16 occur here


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
        extra = [np.ascontiguousarray(rank),
                 np.zeros((C, LANES, CHUNK_SUB), np.float32)]
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
