"""The port's SpMM (hprlp_tpu_torch/ops/spmm.py, ops/sparse.py) on the CPU:
the plain version against the JAX package's spmm (gather backend, ELL
buckets) and scipy, the dense dispatch, the kernel's launch plan, and the
wrapper's refusals.  The kernel itself is tested on the card by
tests/test_torch_spmm_gpu.py.

Tolerances: 1e-5 * max|Y| in f32 and 1e-13 * max|Y| in f64 -- the
summation order differs between CSR rows, ELL buckets and scipy.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

from hprlp_tpu.ops.device_problem import build_device_problem as jax_build
from hprlp_tpu.ops.sparse import spmm as jax_spmm
from hprlp_tpu.ops.sparse import to_coo
from hprlp_tpu.problem import LpProblem as JaxLpProblem
from hprlp_tpu_torch.ops import sparse
from hprlp_tpu_torch.ops import spmm as spmm_mod
from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.spmm import csr_spmm, spmm_plan, spmm_reference

# The tensors here are small: one intra-op thread keeps this test worker
# from competing with the suite's other workers for cores.
torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
NP = {torch.float32: np.float32, torch.float64: np.float64}


def _matrix(seed, m=70, n=90):
    """Random A with empty rows (10-19) and one dense row (3)."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.08, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tolil()
    A[10:20, :] = 0.0
    A[3, :] = rng.normal(size=n)
    return A.tocsr()


def _jax_pair(A, dtype):
    """The JAX package's device matrix of A and the port's CSR copy of
    it, on the same padded positions."""
    m, n = A.shape
    x0 = np.zeros(n)
    prob = JaxLpProblem.from_arrays(A, A @ x0 - 1, A @ x0 + 1, x0 - 1,
                                    x0 + 1, np.ones(n))
    lp, _ = jax_build(prob, dtype=NP[dtype])
    r, c, v = to_coo(lp.A)
    return lp.A, csr_from_coo(r, c, v, lp.A.nrows, lp.A.ncols, dtype, "cpu")


def _close(Y, Y_ref, dtype):
    Y = np.asarray(Y, np.float64)
    Y_ref = np.asarray(Y_ref, np.float64)
    scale = max(1.0, float(np.abs(Y_ref).max()))
    assert np.abs(Y - Y_ref).max() <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 4, 33])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_spmm_and_scipy(seed, B, dtype):
    A = _matrix(seed)
    A_j, M = _jax_pair(A, dtype)
    X = np.random.default_rng(seed + 10).normal(size=(M.ncols, B)).astype(
        NP[dtype])
    Y = spmm_reference(M, torch.as_tensor(X))
    assert Y.shape == (M.nrows, B) and Y.dtype == dtype
    _close(Y.numpy(), np.asarray(jax_spmm(A_j, jnp.asarray(X))), dtype)
    r, c, v = to_coo(A_j)
    S = sp.coo_matrix((v, (r, c)), shape=(M.nrows, M.ncols)).tocsr()
    _close(Y.numpy(), S @ X.astype(np.float64), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_empty_rows_and_the_dispatch(dtype):
    A = _matrix(2)
    C = sp.coo_matrix(A)
    M = csr_from_coo(C.row, C.col, C.data, 70, 90, dtype, "cpu")
    X = torch.as_tensor(np.random.default_rng(2).normal(size=(90, 33))
                        ).to(dtype)
    Y = sparse.spmm(M, X)
    assert bool((Y[10:20] == 0).all())
    _close(Y.numpy(), A @ X.numpy().astype(np.float64), dtype)
    D = sparse.with_backend(M, "dense")
    np.testing.assert_array_equal(D.dense.numpy(), A.toarray().astype(
        NP[dtype]))
    _close(sparse.spmm(D, X).numpy(), Y.numpy(), dtype)
    assert sparse.with_backend(D, "gather").dense is None
    assert D.with_vals(D.vals * 2).dense is None  # the copy would go stale


def test_dense_product_runs_without_tf32(monkeypatch):
    """The dense product turns TF32 off around its matmul and restores the
    caller's setting after it."""
    seen = []
    real = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda a, b: (
        seen.append(torch.backends.cuda.matmul.allow_tf32), real(a, b))[1])
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    M = sparse.with_backend(csr_from_coo([0, 1], [1, 0], [2.0, 3.0], 2, 2,
                                         torch.float32, "cpu"), "dense")
    Y = sparse.spmm(M, torch.ones(2, 3))
    assert seen == [False]
    assert torch.backends.cuda.matmul.allow_tf32 is True
    np.testing.assert_array_equal(Y.numpy(), [[2.0] * 3, [3.0] * 3])


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B", [1, 2, 3, 4, 8, 31, 32, 33, 64, 100, 256,
                               1000])
def test_plan_covers_b_with_aligned_loads(B, itemsize):
    for address in (0, itemsize, 2 * itemsize, 16, 512):
        G, V, n_slices = spmm_plan(B, itemsize, address)
        assert G in (1, 2, 4, 8, 16, 32) and V * itemsize <= 16
        assert B % V == 0 and address % (V * itemsize) == 0
        assert n_slices * G * V >= B > (n_slices - 1) * G * V
        assert G == 32 or G * V >= B  # one slice unless a warp is too few
    # The widest load the alignment allows.
    if B % 4 == 0 and itemsize == 4:
        assert spmm_plan(B, 4, 512)[1] == 4
        assert spmm_plan(B, 4, 8)[1] == 2
    assert spmm_plan(B, itemsize, itemsize)[1] == 1  # one element in


def test_wrapper_refuses_cpu_and_foreign_devices():
    """No hidden fallback: the wrapper takes only CUDA tensors, and the
    dispatcher raises on a device it does not know."""
    M = csr_from_coo([0], [0], [1.0], 4, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        csr_spmm(M, torch.ones(4, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        sparse.spmm(M, torch.ones(4, 2, device="meta"))


def test_failed_build_raises_and_does_not_fall_back(monkeypatch):
    """A kernel that does not build raises from the wrapper; the plain
    version is never called in its place."""
    def no_build(source=None, ptxas_log=None):
        raise RuntimeError("nvcc failed (1): stand-in")

    def no_plain(A, X):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(spmm_mod, "build", no_build)
    monkeypatch.setattr(spmm_mod, "check_spmm_args", lambda A, X: None)
    monkeypatch.setattr(spmm_mod, "spmm_reference", no_plain)
    spmm_mod._library.cache_clear()
    M = csr_from_coo([0], [0], [1.0], 4, 4, torch.float32, "cpu")
    before = csr_spmm.launches
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            csr_spmm(M, torch.ones(4, 2))
    finally:
        spmm_mod._library.cache_clear()
    assert csr_spmm.launches == before


def test_byte_bound_counts_b_columns():
    """Phase 9's bound: each entry's value and index, indptr, and X and Y
    once each (sparse_large's A, f32, B=64: 18.23 us at 3.35 TB/s)."""
    from hprlp_tpu_torch.prof import timing

    class Shape:
        nnz, nrows, ncols = 1_310_638, 65536, 131072

    assert timing.spmv_bytes(Shape, torch.float32, 64) == 61_078_900
    assert timing.spmv_bytes(Shape, torch.float32, 1) == \
        timing.spmv_bytes(Shape, torch.float32)
    ms, by = timing.spmv_bound(Shape, torch.float32, 64)
    assert by == "bytes" and ms == pytest.approx(61_078_900 / 3.35e9)
