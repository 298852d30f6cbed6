"""The tiled SpMV kernel (csrc/spmv_tiled.cu) on the card.

Every test here needs a CUDA device (the kernel has no CPU mode) and skips
without one.  The file imports neither JAX nor the JAX package, so that it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_tiles_gpu.py

The edge cases (CASES) are shared with tests/test_torch_tiles.py, which
checks the layout and the plain version on the CPU.  Tolerances: 1e-5 *
max|y| in f32 and 1e-12 * max|y| in f64 -- the kernel sums each row by
its own fixed tree, the plain version in column order.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.sparse import spmv
from hprlp_tpu_torch.ops.spmv import TILED_STAGES, csr_spmv, tiled_spmv
from hprlp_tpu_torch.ops.tiles import build_tiles, tiled_spmv_reference

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _random(seed, m, n, density):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=density, random_state=rng,
                     data_rvs=lambda k: rng.normal(size=k)).tocoo()


def _empty_rows():
    A = _random(1, 2000, 3000, 0.004).tocsr()
    A[::2] = 0
    A.eliminate_zeros()
    return A.tocoo()


def _long_row():
    A = _random(2, 300, 9000, 0.002).tolil()
    A[7, :6000] = np.linspace(-1.0, 1.0, 6000)
    return A.tocoo()


def _fanout():
    A = _random(3, 600, 800, 0.01).tolil()
    A[:, 5] = 1.5
    return A.tocoo()


def _coo(rows, cols, vals, m, n):
    return sp.coo_matrix((np.asarray(vals, float), (rows, cols)),
                         shape=(m, n))


# name: (matrix, m_pad, n_pad, build_tiles keywords)
CASES = {
    "random": (lambda: _random(0, 3000, 5000, 0.004), 3000, 5000, {}),
    "empty_rows": (_empty_rows, 2000, 3000, {}),
    "padding_rows": (lambda: _random(4, 900, 1100, 0.01), 1024, 1280, {}),
    "nnz0": (lambda: _coo([], [], [], 64, 64), 64, 64, {}),
    "one_column": (lambda: _random(5, 500, 1, 0.5), 500, 1, {}),
    "exact_multiple": (lambda: _random(6, 700, 4096, 0.01), 700, 4096,
                       {"strip_width": 1024}),
    "ncols_below_W": (lambda: _random(7, 400, 96, 0.1), 400, 96,
                      {"strip_width": 512}),
    "odd_tail": (lambda: _random(8, 800, 1003, 0.01), 800, 1003,
                 {"strip_width": 256}),
    "long_row": (_long_row, 300, 9000, {}),
    "many_strips_blocks": (lambda: _random(9, 1000, 2000, 0.004), 1000,
                           2000, {"strip_width": 64, "block_rows": 50}),
    "dense_column": (_fanout, 640, 896, {"strip_width": 128}),
    "one_row_blocks": (lambda: _random(10, 200, 300, 0.05), 200, 300,
                       {"block_rows": 1}),
    "strip_groups": (lambda: _random(11, 3000, 5000, 0.004), 3000, 5000,
                     {"strip_width": 256, "strip_groups": 4}),
    "uneven_groups": (lambda: _random(12, 900, 1700, 0.01), 900, 1700,
                      {"strip_width": 256, "strip_groups": 3,
                       "block_rows": 64}),
}


def make_case(name, dtype, device):
    """(CsrMatrix, TiledMatrix, x) of a case; x from a seeded numpy draw."""
    make, m, n, kw = CASES[name]
    A = make()
    M = csr_from_coo(A.row, A.col, A.data, m, n, dtype, device)
    x = np.random.default_rng(11).normal(size=n)
    return M, build_tiles(M, **kw), torch.as_tensor(x, device=device).to(
        dtype)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _assert_close(y, y_ref, tol):
    scale = max(1.0, float(y_ref.abs().max())) if y_ref.numel() else 1.0
    err = float((y - y_ref).abs().max()) if y.numel() else 0.0
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("stage", sorted(TILED_STAGES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case, dtype, stage):
    M, T, x = make_case(case, dtype, cuda)
    before = tiled_spmv.launches
    y = tiled_spmv(T, x, stage)
    torch.cuda.synchronize()
    assert tiled_spmv.launches == before + (T.nnz > 0)
    assert y.shape == (M.nrows,) and y.dtype == dtype
    _assert_close(y, tiled_spmv_reference(T, x), TOL[dtype])
    _assert_close(y, csr_spmv(M, x), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["random", "long_row",
                                  "many_strips_blocks"])
def test_two_launches_are_bitwise_identical(cuda, case, dtype):
    _, T, x = make_case(case, dtype, cuda)
    y1 = tiled_spmv(T, x)
    y2 = tiled_spmv(T, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


def test_spmv_dispatches_to_the_tiled_kernel(cuda):
    M, T, x = make_case("random", torch.float32, cuda)
    before = (tiled_spmv.launches, csr_spmv.launches)
    y = spmv(M.with_tiles(T), x)
    torch.cuda.synchronize()
    assert (tiled_spmv.launches, csr_spmv.launches) == (before[0] + 1,
                                                        before[1])
    _assert_close(y, tiled_spmv_reference(T, x), 1e-5)


def test_kernel_rejects_bad_arguments(cuda):
    _, T, x = make_case("random", torch.float32, cuda)
    with pytest.raises(TypeError):
        tiled_spmv(T, x.double())
    with pytest.raises(ValueError, match="shape"):
        tiled_spmv(T, torch.ones(T.ncols + 1, device=cuda))
    with pytest.raises(ValueError, match="16-byte"):
        tiled_spmv(T, torch.ones(T.ncols + 1, device=cuda)[1:])
    with pytest.raises(ValueError, match="CUDA"):
        tiled_spmv(T, x.cpu())


def test_refused_launch_raises(cuda):
    """A layout whose strips cannot fit shared memory is refused by the
    launch (cudaErrorInvalidValue), and the wrapper raises."""
    import dataclasses

    _, T, x = make_case("random", torch.float32, cuda)
    big = dataclasses.replace(T, max_block_rows=60000)
    with pytest.raises(RuntimeError, match="launch failed"):
        tiled_spmv(big, x)


def test_solve_on_the_card_goes_through_the_tiled_kernel(cuda):
    tiled_spmv.launches = 0
    csr_spmv.launches = 0
    res = ht.solve(np.array([[1.0, 2.0], [3.0, 1.0]]), [-np.inf] * 2,
                   [10.0, 12.0], [0.0, 0.0], [np.inf] * 2, [-3.0, -5.0],
                   ht.Parameters(verbose=False, use_presolve=False))
    assert res.status == "OPTIMAL"
    assert res.primal_obj == pytest.approx(-26.4, abs=1e-2)
    assert tiled_spmv.launches > 0
    assert csr_spmv.launches == 0
