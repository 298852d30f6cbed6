"""The CUDA SpMM kernels (csrc/spmm.cu: the solver's design and the
previous, row-wise one; the y-half's ring kernel against the y-half's
previous design) and the batched solve on the card.

Every test here needs a CUDA device (the kernel has no CPU mode) and skips
without one.  The file imports neither JAX nor the JAX package, so that it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_spmm_gpu.py

Tolerances: 1e-5 (f32) and 1e-12 (f64) relative to the row sums of
|A| |X|, since the kernel's fused multiply-adds round otherwise than the
plain version's products and sums.  The y-half's kernels are held to
bitwise equality: both sum each (row, member) in CSR order, one fma an
entry, and round the update as PyTorch's elementwise kernels do.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.sparse import spmm, with_backend
from hprlp_tpu_torch.ops import spmm as spmm_mod
from hprlp_tpu_torch.ops.spmm import (csr_spmm, csr_spmm_rowwise, spmm_grid,
                                      spmm_plan, spmm_reference, spmm_y_half,
                                      spmm_y_half_previous)
from hprlp_tpu_torch.ops.spmv import csr_spmv, tiled_spmv
from hprlp_tpu_torch.solver import batched as tb

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


# ---------------------------------------------------------------------------
# The y-half's ring kernel against its previous design and the plain ops.

Y_BATCHES = [1, 2, 3, 4, 8, 64, 256]
Y_CASES = ["aligned", "offset1", "offset2", "graph"]


def _y_operands(M, B, dtype, device, offset, seed):
    """x_hat, y, last_y, AL, AU (each a view `offset` elements into its
    own allocation, so 4- or 8-byte aligned when offset is 1 or 2, f32),
    lam_sigma, inner and active (a third of the members frozen) from
    numpy; AL and AU infinite in places."""
    rng = np.random.default_rng(seed)

    def view(a):
        base = torch.empty(a.size + offset, dtype=dtype, device=device)
        out = base[offset:].view(a.shape)
        out.copy_(torch.as_tensor(a))
        return out

    lo = rng.normal(size=(M.nrows, B))
    AL = np.where(rng.random((M.nrows, B)) < 0.3, -np.inf, lo)
    AU = np.where(rng.random((M.nrows, B)) < 0.3, np.inf,
                  lo + rng.uniform(0.0, 2.0, (M.nrows, B)))
    return (view(rng.normal(size=(M.ncols, B))),
            view(rng.normal(size=(M.nrows, B))),
            view(rng.normal(size=(M.nrows, B))), view(AL), view(AU),
            torch.as_tensor(rng.uniform(0.5, 3.0, B), device=device).to(
                dtype),
            torch.as_tensor(rng.integers(0, 40, B).astype(np.int32),
                            device=device),
            torch.as_tensor(rng.random(B) < 0.67, device=device))


@pytest.mark.parametrize("case", Y_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", Y_BATCHES)
def test_y_half_ring_equals_previous_and_plain_bitwise(cuda, B, dtype,
                                                       case):
    """The ring kernel's y_new is bitwise the previous design's and the
    plain ops' on the card's SpMM, on a matrix with 40 empty rows, a row
    of 12,000 entries (longer than any ring) and frozen members; with the
    operands 4 or 8 bytes off alignment (narrower copies); and replayed
    from a CUDA graph.  One launch a call."""
    M = _port(dtype, cuda)
    assert int((M.indptr[8] - M.indptr[7]).item()) >= 4096
    offset = {"offset1": 1, "offset2": 2}.get(case, 0)
    x_hat, y, last_y, AL, AU, lam, inner, active = _y_operands(
        M, B, dtype, cuda, offset, seed=100 * B + offset)
    args = (M, x_hat, y, last_y, AL, AU, lam, inner, active, 3)
    before = (spmm_y_half.launches, spmm_y_half_previous.launches)
    if case == "graph":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            spmm_y_half(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y_new = spmm_y_half(*args)
        y_new.fill_(float("nan"))
        graph.replay()
        assert spmm_y_half.launches == before[0] + 2
    else:
        y_new = spmm_y_half(*args)
        assert spmm_y_half.launches == before[0] + 1
    y_prev = spmm_y_half_previous(*args)
    assert spmm_y_half_previous.launches == before[1] + 1
    lp = types.SimpleNamespace(A=M, AL=AL, AU=AU)
    y_plain = tb.y_half_plain(lp, y, x_hat, last_y, lam[None, :], inner, 3,
                              active)
    torch.cuda.synchronize()
    assert torch.equal(y_new, y_prev)
    assert torch.equal(y_new, y_plain)
    assert torch.equal(y_new[:, ~active], y[:, ~active])
    assert bool(torch.isfinite(y_new).all())


def test_first_launch_of_a_process_may_be_captured(cuda):
    """In a fresh process the ring kernel's first use, library load and
    shared-memory set-up included, may happen inside a CUDA-graph
    capture."""
    code = """
import torch
from hprlp_tpu_torch.ops import spmm as sm
from hprlp_tpu_torch.ops.device_problem import csr_from_coo
M = csr_from_coo([0, 1, 2, 2], [0, 1, 0, 2], [1.0, 2.0, 3.0, 4.0], 3, 3,
                 torch.float32, "cuda")
g = torch.Generator(device="cuda").manual_seed(0)
x, y = (torch.randn(3, 8, device="cuda", generator=g) for _ in range(2))
AL, AU = -torch.ones(3, 8, device="cuda"), torch.ones(3, 8, device="cuda")
lam = torch.ones(8, device="cuda")
inner = torch.zeros(8, dtype=torch.int32, device="cuda")
act = torch.ones(8, dtype=torch.bool, device="cuda")
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph):
    out = sm.spmm_y_half(M, x, y, y, AL, AU, lam, inner, act, 0)
graph.replay()
ref = sm.spmm_y_half_previous(M, x, y, y, AL, AU, lam, inner, act, 0)
torch.cuda.synchronize()
assert torch.equal(out, ref), (out, ref)
print("captured first: ok")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "captured first: ok" in proc.stdout


def test_solve_batched_never_launches_the_previous_y_half(cuda):
    B = 4
    C = np.outer([-3.0, -5.0], np.arange(1, B + 1, dtype=float))
    spmm_y_half.launches = spmm_y_half_previous.launches = 0
    out = ht.solve_batched(
        np.array([[1.0, 2.0], [3.0, 1.0]]), C, np.full((2, B), -np.inf),
        np.tile([[10.0], [12.0]], (1, B)), np.zeros((2, B)),
        np.full((2, B), np.inf), params=ht.Parameters(verbose=False))
    assert out.status == ["OPTIMAL"] * B
    assert spmm_y_half.launches > 0
    assert spmm_y_half_previous.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refused_ring_launches_raise(cuda, dtype):
    """No fallback: the kernel's own checks refuse a grid that does not
    cover the rows, slices that do not cover B and a vector width that
    does not divide B, and the wrapper raises; nothing is counted.  (No
    plan can exceed the card's shared memory: the source asserts each
    instance's bytes against it when it compiles.)"""
    M = _port(dtype, cuda)
    args = _y_operands(M, 64, dtype, cuda, 0, seed=5)
    x_hat, y, last_y, AL, AU, lam, inner, active = args
    plan = spmm_mod.ring_plan(M.nrows, M.ncols, 64, y.element_size(), 0)
    assert plan.G > 1 and plan.V > 1
    before = spmm_y_half.launches
    out = torch.empty_like(y)
    for bad in (plan._replace(grid_x=plan.grid_x - 1),
                plan._replace(G=plan.G // 2),
                plan._replace(V=3)):
        with pytest.raises(RuntimeError, match="ring kernel failed"):
            spmm_mod._ring_launch(M, x_hat, out, y, last_y, AL, AU, lam,
                                  inner, active, 0, plan=bad)
    assert spmm_y_half.launches == before
