"""The CUDA SpMM kernels (csrc/spmm.cu: the solver's design and the
previous, row-wise one) and the batched solve on the card.

Every test here needs a CUDA device (the kernel has no CPU mode) and skips
without one.  The file imports neither JAX nor the JAX package, so that it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_spmm_gpu.py

Tolerances: 1e-5 (f32) and 1e-12 (f64) relative to the row sums of
|A| |X|, since the kernel's fused multiply-adds round otherwise than the
plain version's products and sums.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.sparse import spmm, with_backend
from hprlp_tpu_torch.ops import spmm as spmm_mod
from hprlp_tpu_torch.ops.spmm import (csr_spmm, csr_spmm_rowwise, spmm_grid,
                                      spmm_plan, spmm_reference)
from hprlp_tpu_torch.ops.spmv import csr_spmv, tiled_spmv

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
BATCHES = [1, 3, 8, 32, 33, 64, 256]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


M_ROWS, N_COLS = 2000, 12000


def _matrix():
    """M_ROWS x N_COLS, ~12 entries per row, with 40 empty rows, one full
    row (12,000 entries) and a full column."""
    rng = np.random.default_rng(11)
    A = sp.random(M_ROWS, N_COLS, density=0.001, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tolil()
    A[100:140, :] = 0.0
    A[7, :] = rng.normal(size=N_COLS)
    A[:, 5] = 1.5
    A[100:140, 5] = 0.0
    return sp.coo_matrix(A.tocsr())


def _port(dtype, device):
    A = _matrix()
    return csr_from_coo(A.row, A.col, A.data, M_ROWS, N_COLS, dtype, device)


def _err(Y, Y_ref, M, X):
    """Max |Y - Y_ref| over the row sums of |A| |X| (floored at 1)."""
    scale = spmm_reference(M.with_vals(M.vals.abs()), X.abs())
    return float(((Y - Y_ref).abs() / torch.clamp(scale, min=1.0)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", BATCHES)
def test_kernel_matches_plain(cuda, B, dtype):
    M = _port(dtype, cuda)
    assert int((M.indptr[8] - M.indptr[7]).item()) == N_COLS
    X = torch.as_tensor(np.random.default_rng(B).normal(size=(N_COLS, B)),
                        device=cuda).to(dtype)
    before = csr_spmm.launches
    Y = spmm(M, X)
    torch.cuda.synchronize()
    assert csr_spmm.launches == before + 1
    assert Y.shape == (M_ROWS, B) and Y.dtype == dtype
    assert _err(Y, spmm_reference(M, X), M, X) <= TOL[dtype]
    assert bool((Y[100:140] == 0).all())  # empty rows write zeros
    assert torch.equal(Y, csr_spmm(M, X))  # deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_misaligned_x_takes_scalar_loads(cuda, dtype):
    """A view of X that starts one element in cannot take vector loads."""
    M = _port(dtype, cuda)
    base = torch.randn(N_COLS * 64 + 1, device=cuda, dtype=dtype)
    X = base[1:].view(N_COLS, 64)
    assert spmm_plan(64, X.element_size(), X.data_ptr())[1] == 1
    Y = csr_spmm(M, X)
    torch.cuda.synchronize()
    assert _err(Y, spmm_reference(M, X), M, X) <= TOL[dtype]


def test_dense_backend_matches_kernel(cuda):
    M = _port(torch.float32, cuda)
    X = torch.randn(N_COLS, 64, device=cuda)
    before = csr_spmm.launches
    Y = spmm(with_backend(M, "dense"), X)
    assert csr_spmm.launches == before
    assert _err(Y, csr_spmm(M, X), M, X) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", BATCHES)
def test_new_design_equals_the_previous_bitwise(cuda, B, dtype):
    """Both designs sum each output in CSR order, one fma an entry: the
    same bits, whatever the slices; other plans of the solver's design
    (one-lane groups, so many slices, or no L2 cap) change nothing
    either."""
    M = _port(dtype, cuda)
    X = torch.as_tensor(np.random.default_rng(B + 1).normal(
        size=(N_COLS, B)), device=cuda).to(dtype)
    before = csr_spmm_rowwise.launches
    Y = csr_spmm(M, X)
    assert torch.equal(Y, csr_spmm_rowwise(M, X))
    assert csr_spmm_rowwise.launches == before + 1
    G, V, n_slices = spmm_plan(B, X.element_size(), X.data_ptr())
    for g, s in ((1, -(-B // V)), (G, n_slices)):
        Y_other = torch.empty_like(Y)
        spmm_mod._launch(spmm_mod.STORE, M, X, Y_other,
                         plan=(g, V, *spmm_grid(M_ROWS, g, s)))
        assert torch.equal(Y, Y_other)


def test_kernel_rejects_bad_arguments(cuda):
    M = csr_from_coo([0], [0], [1.0], 4, 4, torch.float32, cuda)
    with pytest.raises(TypeError):
        csr_spmm(M, torch.ones(4, 2, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        csr_spmm(M, torch.ones(5, 2, device=cuda))
    with pytest.raises(ValueError):
        csr_spmm(M, torch.ones(4, device=cuda))
    with pytest.raises(ValueError):
        csr_spmm(M, torch.ones(2, 4, device=cuda).t())
    with pytest.raises(ValueError, match="CUDA"):
        csr_spmm(M, torch.ones(4, 2))


def test_batched_solve_goes_through_the_kernels(cuda):
    """SpMMs on the SpMM kernel, the power method on the tiled SpMV, and
    never the CSR SpMV."""
    B = 4
    C = np.outer([-3.0, -5.0], np.arange(1, B + 1, dtype=float))
    csr_spmm.launches = tiled_spmv.launches = csr_spmv.launches = 0
    out = ht.solve_batched(
        np.array([[1.0, 2.0], [3.0, 1.0]]), C, np.full((2, B), -np.inf),
        np.tile([[10.0], [12.0]], (1, B)), np.zeros((2, B)),
        np.full((2, B), np.inf), params=ht.Parameters(verbose=False))
    assert out.status == ["OPTIMAL"] * B
    np.testing.assert_allclose(out.primal_obj, -26.4 * np.arange(1, B + 1),
                               rtol=1e-2)
    assert csr_spmm.launches > 0 and tiled_spmv.launches > 0
    assert csr_spmv.launches == 0
