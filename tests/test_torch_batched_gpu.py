"""The fused batched halves (csrc/spmm.cu, ops/spmm.py::spmm_x_half and
spmm_y_half) and the deterministic row sums of the scaling on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_batched_gpu.py

Fused and plain are held to bitwise equality: the kernel rounds each step
as PyTorch's elementwise kernels do, on the same SpMM sums.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hprlp_tpu_torch.ops import sparse
from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.spmm import csr_spmm, spmm_x_half, spmm_y_half
from hprlp_tpu_torch.solver import batched as tb
from hprlp_tpu_torch.solver.scaling import scale_matrix

pytestmark = pytest.mark.gpu

M_ROWS, N_COLS = 300, 500
FIELDS = ("x", "y", "last_x", "last_y", "x_bar", "y_bar", "z_bar", "y_obj",
          "inner")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _problem(B, dtype, device, seed=0):
    """A random A (one empty row, one dense row) and per-member vectors
    with infinite bounds in places, a random state, sigma, active mask
    (member 0 frozen) and a lambda above ||A||^2, so that the iterates
    stay finite."""
    rng = np.random.default_rng(seed)
    A = sp.random(M_ROWS, N_COLS, density=0.02, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tolil()
    A[5, :] = 0.0
    A[9, :] = rng.normal(size=N_COLS)
    A = sp.coo_matrix(A.tocsr())
    AT = sp.coo_matrix(A.T.tocsr())

    def dev(a):
        return torch.as_tensor(a, device=device).to(dtype)

    lo = rng.normal(size=(M_ROWS, B)) - 1.0
    AL = np.where(rng.random((M_ROWS, B)) < 0.3, -np.inf, lo)
    AU = np.where(rng.random((M_ROWS, B)) < 0.3, np.inf,
                  lo + rng.uniform(0.0, 2.0, (M_ROWS, B)))
    l = np.where(rng.random((N_COLS, B)) < 0.3, -np.inf,
                 rng.normal(size=(N_COLS, B)) - 1.0)
    u = np.where(rng.random((N_COLS, B)) < 0.3, np.inf,
                 np.maximum(l, 0.0) + rng.uniform(0.0, 3.0, (N_COLS, B)))
    lam = 1.01 * np.linalg.norm(A.toarray(), 2) ** 2  # >= ||A||^2
    lp = tb.BatchedLpDevice(
        A=csr_from_coo(A.row, A.col, A.data, M_ROWS, N_COLS, dtype, device),
        AT=csr_from_coo(AT.row, AT.col, AT.data, N_COLS, M_ROWS, dtype,
                        device),
        AL=dev(AL), AU=dev(AU), c=dev(rng.normal(size=(N_COLS, B))),
        l=dev(l), u=dev(u))
    shapes = {"x": N_COLS, "last_x": N_COLS, "x_bar": N_COLS,
              "z_bar": N_COLS, "y": M_ROWS, "last_y": M_ROWS,
              "y_bar": M_ROWS, "y_obj": M_ROWS}
    state = tb.BatchedState(
        **{k: dev(rng.normal(size=(n, B))) for k, n in shapes.items()},
        inner=torch.as_tensor(rng.integers(0, 40, B).astype(np.int32),
                              device=device))
    sigma = dev(rng.uniform(0.2, 4.0, B))
    active = torch.as_tensor(rng.random(B) < 0.7, device=device)
    active[0] = False
    return lp, state, sigma, active, lam


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 3, 8, 64])
def test_fused_halves_equal_plain_bitwise(cuda, B, dtype):
    lp, st, sigma, active, lam = _problem(B, dtype, cuda, seed=B)
    sig = sigma[None, :]
    lam_sigma = lam * sig
    for t in (0, 5):
        before = (spmm_x_half.launches, spmm_y_half.launches)
        x_new, x_hat = tb.x_half(lp, st.x, st.y, st.last_x, sig, st.inner,
                                 t, active)
        y_new = tb.y_half(lp, st.y, x_hat, st.last_y, lam_sigma, st.inner, t,
                          active)
        assert (spmm_x_half.launches, spmm_y_half.launches) == (
            before[0] + 1, before[1] + 1)
        x_ref, hat_ref = tb.x_half_plain(lp, st.x, st.y, st.last_x, sig,
                                         st.inner, t, active)
        y_ref = tb.y_half_plain(lp, st.y, hat_ref, st.last_y, lam_sigma,
                                st.inner, t, active)
        torch.cuda.synchronize()
        assert torch.equal(x_hat, hat_ref)
        assert torch.equal(x_new, x_ref)
        assert torch.equal(y_new, y_ref)
        assert torch.equal(x_new[:, ~active], st.x[:, ~active])
        assert torch.equal(y_new[:, ~active], st.y[:, ~active])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_chunk_equals_plain_chunk_bitwise(cuda, dtype, monkeypatch):
    """A whole run_batched_chunk (20 iterations, restart flags mixed,
    members frozen) through the fused halves and through the plain ones:
    every state tensor and metric bitwise equal."""
    B = 8
    lp, st, sigma, active, lam = _problem(B, dtype, cuda, seed=3)
    ones_m = torch.ones(M_ROWS, dtype=dtype, device=cuda)
    ones_n = torch.ones(N_COLS, dtype=dtype, device=cuda)
    flag = torch.arange(B, device=cuda) % 3 == 0
    lam = torch.full((B,), lam, dtype=dtype, device=cuda)
    args = (lp, ones_m, ones_n, st, sigma, lam, flag, active, 20)
    before = spmm_x_half.launches
    st_f, m_f = tb.run_batched_chunk(*args)
    assert spmm_x_half.launches == before + 18
    monkeypatch.setattr(tb, "x_half", tb.x_half_plain)
    monkeypatch.setattr(tb, "y_half", tb.y_half_plain)
    st_p, m_p = tb.run_batched_chunk(*args)
    assert spmm_x_half.launches == before + 18
    assert bool(torch.isfinite(st_f.x).all() & torch.isfinite(st_f.y).all())
    for k in FIELDS:
        assert torch.equal(getattr(st_f, k), getattr(st_p, k)), k
    for k in m_f:
        assert torch.equal(m_f[k], m_p[k]), k


def test_dense_copy_keeps_the_plain_halves(cuda):
    lp, st, sigma, active, _ = _problem(4, torch.float32, cuda)
    dense = dataclasses.replace(lp, A=sparse.with_backend(lp.A, "dense"),
                                AT=sparse.with_backend(lp.AT, "dense"))
    before = (spmm_x_half.launches, spmm_y_half.launches)
    x_new, x_hat = tb.x_half(dense, st.x, st.y, st.last_x, sigma[None, :],
                             st.inner, 0, active)
    tb.y_half(dense, st.y, x_hat, st.last_y, sigma[None, :], st.inner, 0,
              active)
    assert (spmm_x_half.launches, spmm_y_half.launches) == before


def test_fused_halves_reject_bad_arguments(cuda):
    lp, st, sigma, active, _ = _problem(4, torch.float32, cuda)
    good = (lp.AT, st.y, st.x, st.last_x, lp.c, lp.l, lp.u, sigma,
            st.inner, active, 0)
    spmm_x_half(*good)
    for i, bad, err in ((7, sigma.double(), TypeError),
                        (8, st.inner.long(), TypeError),
                        (9, active.int(), TypeError),
                        (2, st.x[:, :3].contiguous(), ValueError),
                        (3, st.last_x.cpu(), ValueError)):
        args = list(good)
        args[i] = bad
        with pytest.raises(err):
            spmm_x_half(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scale_matrix_is_bitwise_repeatable(cuda, dtype):
    """Its row sums run on the SpMM kernel (CSR order), so two runs give
    the same bits; they agree with the CPU's scaling to rounding."""
    lp = _problem(1, dtype, cuda)[0]
    before = csr_spmm.launches
    runs = [scale_matrix(lp.A, lp.AT) for _ in range(2)]
    assert csr_spmm.launches > before
    (a1, at1, r1, c1), (a2, at2, r2, c2) = runs
    assert torch.equal(a1.vals, a2.vals) and torch.equal(at1.vals, at2.vals)
    assert torch.equal(r1, r2) and torch.equal(c1, c2)
    cpu = scale_matrix(*(dataclasses.replace(
        M, indptr=M.indptr.cpu(), indices=M.indices.cpu(), vals=M.vals.cpu())
        for M in (lp.A, lp.AT)))
    rtol = 1e-4 if dtype == torch.float32 else 1e-10
    torch.testing.assert_close(r1.cpu(), cpu[2], rtol=rtol, atol=0.0)
    torch.testing.assert_close(c1.cpu(), cpu[3], rtol=rtol, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_sums_on_the_card(cuda, dtype):
    lp = _problem(1, dtype, cuda)[0]
    per_entry = torch.randn(lp.A.nnz, dtype=dtype, device=cuda)
    got = sparse._row_reduce(lp.A, per_entry, "sum")
    assert torch.equal(got, sparse._row_reduce(lp.A, per_entry, "sum"))
    want = torch.zeros(M_ROWS, dtype=torch.float64, device=cuda).index_add_(
        0, sparse.row_of_entry(lp.A), per_entry.double())
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((got.double() - want).abs().max()) <= tol * max(
        1.0, float(want.abs().max()))
    assert float(got[5]) == 0.0  # the empty row
