"""The SpMV variant-study kernels on the card: the ablate, multi_acc and
flush families (csrc/spmv_csr.cu on the row-block plan) and the segsum
family (csrc/spmv_tiled.cu on the tiles).

Every family and variant against its plain version on the same card, at
small shapes that reach each kernel's edges: empty rows (runs of more than
32 within blocks and segsum sub-blocks), a row across many 128-entry warp
segments and one longer than the row-block plan's window of 2048 entries
(a block of its own), rows split across segments, a block's last step and
segsum steps, blocks of 256 short rows, segsum sub-blocks of 16 ranks and
steps across more than 16 rows (one entry a row), tiles of two strip
groups, mean row lengths 1..30, and more than one 16384-entry x window.
One launch per call.

Every test needs a CUDA device (the kernels have no CPU mode) and skips
without one.  The file imports neither JAX nor the JAX package, so that it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_spmv_variants_gpu.py

Tolerance: a `bitwise` variant (ablate full, multi_acc, flush full: the
plain version repeats the kernel's order of sums on the plan) equals its
plain version bit for bit, and so does flush runmerge (runmerge_plain
repeats its segmented warp scan); every other variant is within its tol
(ops/spmv_variants.VARIANTS: 1e-5, 1e-4 for segsum/mm_precomp) times
max(1, max|y_plain|).  The tensor cores' sums run in another order than
the plain versions', and merge_all's atomicAdd in an order that changes
between runs.  The exact variants are also held to A @ x at their tol.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.sparse import with_spmv_backend
from hprlp_tpu_torch.ops.spmv import csr_spmv, csr_spmv_plain, spmv_reference
from hprlp_tpu_torch.ops.spmv_variants import (VARIANTS, WRAPPERS, plain,
                                               segsum_rtiles, segsum_tiles,
                                               spmv_ablate, spmv_flush,
                                               spmv_multi_acc, spmv_segsum)
from hprlp_tpu_torch.ops.tiles import build_tiles

pytestmark = pytest.mark.gpu


def _random(seed, m, n, mean_row):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=mean_row / n, random_state=rng,
                     data_rvs=lambda k: rng.normal(size=k)).tocoo()


def _empty_rows():
    """Entries in every 40th row only (5..44 each): runs of 39 empty rows
    inside warp runs and segsum sub-blocks."""
    rng = np.random.default_rng(5)
    rows = np.concatenate([np.full(5 + r % 40, r) for r in range(0, 2000, 40)])
    return sp.coo_matrix((rng.normal(size=len(rows)),
                          (rows, rng.integers(0, 900, len(rows)))),
                         shape=(2000, 900))


def _long_row():
    """One row of 700 entries (three warp runs) among rows of 0..3."""
    rng = np.random.default_rng(6)
    rows = np.concatenate([np.full(700, 17), rng.integers(0, 300, 500)])
    A = sp.coo_matrix((rng.normal(size=len(rows)),
                       (rows, rng.integers(0, 800, len(rows)))),
                      shape=(300, 800))
    A.sum_duplicates()
    return A


def _cap_row():
    """One row of 3000 entries, more than the plan's window of 2048 (a
    block of its own), among rows of 0..8 entries."""
    rng = np.random.default_rng(8)
    rows = np.concatenate([np.full(3000, 123), rng.integers(0, 400, 1600)])
    cols = np.concatenate([rng.permutation(5000)[:3000],
                           rng.integers(0, 5000, 1600)])
    A = sp.coo_matrix((rng.normal(size=len(rows)), (rows, cols)),
                      shape=(400, 5000))
    A.sum_duplicates()
    return A


def _one_per_row():
    """One entry in each of 3000 rows: runs of a hundred rows of one entry,
    so segsum sub-blocks of 16 ranks and warp steps across 128 rows."""
    rng = np.random.default_rng(10)
    return sp.coo_matrix((rng.normal(size=3000),
                          (np.arange(3000), rng.integers(0, 3500, 3000))),
                         shape=(3000, 3500))


def _tiny():
    return sp.coo_matrix((np.array([1.0, 2.0, 3.0]),
                          (np.array([0, 0, 1]), np.array([0, 1, 0]))),
                         shape=(130, 130))


# name -> COO matrix; mean row lengths 1..30 (the row-group design's 2..32
# threads per row, whose names they keep); "block256": 1200 rows of ~1
# entry, cut into blocks of 256 rows.
CASES = {
    "block256": lambda: _random(9, 1200, 1500, 1.0),
    "cap_row": _cap_row,
    "tpr2": lambda: _random(1, 900, 1100, 1.5),
    "tpr8": lambda: _random(2, 700, 1000, 6),
    "tpr16": lambda: _random(3, 600, 1200, 12),
    "tpr32": lambda: _random(4, 500, 900, 30),
    "windows": lambda: _random(7, 400, 40000, 20),
    "empty_rows": _empty_rows,
    "long_row": _long_row,
    "one_per_row": _one_per_row,
    "tiny": _tiny,
}

FAMILY_VARIANTS = [(f, v) for f in VARIANTS for v in VARIANTS[f]]


def case_matrix(case, device, plan=True):
    """The case on `device`, with the row-block plan attached (the "gather"
    backend's layout) unless `plan` is False."""
    A = CASES[case]()
    M = csr_from_coo(A.row, A.col, A.data, A.shape[0], A.shape[1],
                     torch.float32, device)
    return with_spmv_backend(M, "gather") if plan else M


def case_x(M):
    x = np.random.default_rng(11).normal(size=M.ncols)
    return torch.as_tensor(x, dtype=torch.float32, device=M.device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("family,name", FAMILY_VARIANTS,
                         ids=[f"{f}-{v}" for f, v in FAMILY_VARIANTS])
def test_variant_kernel_matches_plain(cuda, family, name, case):
    M = case_matrix(case, cuda)
    x = case_x(M)
    wrapper = WRAPPERS[family]
    before = wrapper.launches
    y = wrapper(M, x, name)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    v = VARIANTS[family][name]
    y_plain = plain(family, M, x, name)
    scale = max(1.0, float(y_plain.abs().max()))
    if v.bitwise:
        assert torch.equal(y, y_plain)
    assert float((y - y_plain).abs().max()) <= v.tol * scale
    if v.exact:
        assert float((y - spmv_reference(M, x)).abs().max()) <= v.tol * scale


def test_variant_kernels_reject_bad_arguments(cuda):
    M = case_matrix("tiny", cuda)
    with pytest.raises(TypeError, match="f32"):
        WRAPPERS["ablate"](M.with_vals(M.vals.double()),
                           torch.ones(130, device=cuda, dtype=torch.float64),
                           "full")
    with pytest.raises(ValueError):
        WRAPPERS["flush"](M, torch.ones(131, device=cuda), "runmerge")
    with pytest.raises(ValueError, match="unknown variant"):
        WRAPPERS["multi_acc"](M, torch.ones(130, device=cuda), "n_acc=3")
    x = torch.ones(130, device=cuda)
    other = segsum_rtiles(build_tiles(M, strip_width=64))
    with pytest.raises(ValueError, match="rtiles"):
        spmv_segsum(M, x, "mm_precomp", rtiles=other,
                    tiles=segsum_tiles(M))
    B = case_matrix("tpr8", cuda)
    with pytest.raises(ValueError, match="another matrix"):
        spmv_segsum(M, case_x(B), "mm_hi1", tiles=segsum_tiles(B))
    # One strip that leaves no room for any variant's staging.
    W = case_matrix("windows", cuda)
    T = build_tiles(W, strip_width=57344)
    for name in VARIANTS["segsum"]:
        with pytest.raises(ValueError, match="staging"):
            spmv_segsum(W, case_x(W), name, tiles=T)


PLAN_VARIANTS = [(f, v) for f, v in FAMILY_VARIANTS
                 if f in ("ablate", "multi_acc", "flush")]


@pytest.mark.parametrize("family,name", PLAN_VARIANTS,
                         ids=[f"{f}-{v}" for f, v in PLAN_VARIANTS])
def test_plan_variants_refuse_a_matrix_without_its_plan(cuda, family, name):
    """The CSR kernel's variants run on A's row-block plan and never build
    it: without it they raise, launching nothing."""
    M = case_matrix("tpr8", cuda, plan=False)
    before = WRAPPERS[family].launches
    with pytest.raises(ValueError, match="row-block plan"):
        WRAPPERS[family](M, case_x(M), name)
    assert WRAPPERS[family].launches == before


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_variants_are_csr_spmv(cuda, case):
    """ablate full, multi_acc n_acc=1 and flush full are csr_spmv's launch:
    the same bits as csr_spmv and its plain version on the plan, each
    counted by its own wrapper and not by csr_spmv."""
    M = case_matrix(case, cuda)
    x = case_x(M)
    y = csr_spmv(M, x)
    before = csr_spmv.launches
    ys = [spmv_ablate(M, x, "full"), spmv_multi_acc(M, x, "n_acc=1"),
          spmv_flush(M, x, "full")]
    torch.cuda.synchronize()
    assert csr_spmv.launches == before
    assert torch.equal(y, csr_spmv_plain(M, x))
    for other in ys:
        assert torch.equal(y, other)


SEGSUM = list(VARIANTS["segsum"])


@pytest.mark.parametrize("case", ["empty_rows", "one_per_row", "tpr8",
                                  "cap_row"])
@pytest.mark.parametrize("name", SEGSUM)
def test_segsum_on_strip_groups(cuda, name, case):
    """Every segsum variant on tiles of two strip groups and narrow strips
    (each group's partial y, summed by the second pass), against its plain
    version on the same tiles; mm_precomp with its R given and built by
    the wrapper."""
    M = case_matrix(case, cuda)
    T = build_tiles(M, strip_width=128, block_rows=300, strip_groups=2)
    assert T.n_groups == 2
    G = M.with_tiles(T)
    x = case_x(G)
    y = spmv_segsum(G, x, name)
    torch.cuda.synchronize()
    y_plain = plain("segsum", G, x, name)
    scale = max(1.0, float(y_plain.abs().max()))
    assert float((y - y_plain).abs().max()) <= \
        VARIANTS["segsum"][name].tol * scale
    if name == "mm_precomp":
        assert torch.equal(spmv_segsum(G, x, name,
                                       rtiles=segsum_rtiles(T)), y)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("family,name", [("flush", "runmerge"),
                                         ("segsum", "full"),
                                         ("segsum", "mm_precomp"),
                                         ("segsum", "mm_hi1")])
def test_variants_without_atomics_repeat_bitwise(cuda, family, name, case):
    """runmerge and the segsum variants add into rows in a fixed order (no
    atomics): two launches on the same inputs give the same bits."""
    M = case_matrix(case, cuda)
    x = case_x(M)
    y0 = WRAPPERS[family](M, x, name)
    y1 = WRAPPERS[family](M, x, name)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1)
