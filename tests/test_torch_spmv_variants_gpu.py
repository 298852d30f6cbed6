"""The SpMV variant-study kernels (csrc/spmv_variants.cu) on the card.

Every family and variant against its plain version on the same card, at
small shapes that reach each kernel's edges: empty rows (runs of more than
32, and rows 16 or more past a segsum sub-block's first row), a row longer
than a warp run, rows split across runs and tiles, the thread-per-row
widths 2..32, and more than one 16384-entry x window.  One launch per call.

Every test needs a CUDA device (the kernels have no CPU mode) and skips
without one.  The file imports neither JAX nor the JAX package, so that it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_spmv_variants_gpu.py

Tolerance: max abs error <= the variant's tol (ops/spmv_variants.VARIANTS:
1e-5, 1e-4 for segsum/mm_precomp) times max(1, max|y_plain|).  The sums
run in another order than the plain version's, and the atomicAdd variants
in an order that changes between runs: each row there sums at most
2 + len/8 partials, whose rounding stays far inside that bound.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.spmv import spmv_reference
from hprlp_tpu_torch.ops.spmv_variants import (VARIANTS, WRAPPERS, plain,
                                               spmv_segsum)

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


def _tiny():
    return sp.coo_matrix((np.array([1.0, 2.0, 3.0]),
                          (np.array([0, 0, 1]), np.array([0, 1, 0]))),
                         shape=(130, 130))


# name -> COO matrix; mean row lengths 1.5..30 select 2..32 threads per row.
CASES = {
    "tpr2": lambda: _random(1, 900, 1100, 1.5),
    "tpr8": lambda: _random(2, 700, 1000, 6),
    "tpr16": lambda: _random(3, 600, 1200, 12),
    "tpr32": lambda: _random(4, 500, 900, 30),
    "windows": lambda: _random(7, 400, 40000, 20),
    "empty_rows": _empty_rows,
    "long_row": _long_row,
    "tiny": _tiny,
}

FAMILY_VARIANTS = [(f, v) for f in VARIANTS for v in VARIANTS[f]]


def case_matrix(case, device):
    A = CASES[case]()
    return csr_from_coo(A.row, A.col, A.data, A.shape[0], A.shape[1],
                        torch.float32, device)


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
    with pytest.raises(ValueError, match="rtiles"):
        spmv_segsum(M, torch.ones(130, device=cuda), "mm_precomp",
                    rtiles=torch.zeros(2, 32, 2, dtype=torch.int32,
                                       device=cuda))
