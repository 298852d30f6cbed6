"""The port's SpMV (hprlp_tpu_torch/ops/spmv.py, ops/sparse.py) against
scipy and against the four Pallas TPU kernels it replaces (interpret mode,
as tests/test_lane_ell.py runs them), in both layouts: bare CSR and CSR
with column-strip tiles (ops/tiles.py, forced here to many strips and
blocks), each on its plain version.  The kernels themselves are tested on
the card by tests/test_torch_kernel_gpu.py and test_torch_tiles_gpu.py.

Tolerances: 1e-5 * max|y| in f32 and 1e-13 * max|y| in f64 -- the
summation order differs between CSR rows, LaneELL tiles and scipy.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

from hprlp_tpu.ops.lane_ell import schedule_lane_ell, schedule_thin
from hprlp_tpu.ops.pallas_spmv import (lane_spmv, lane_spmv_df64, pack_tiles,
                                       thin_spmv, thin_spmv_df64)
from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.sparse import csr_from_numpy, spmv
from hprlp_tpu_torch.ops.spmv import csr_spmv, threads_per_row
from hprlp_tpu_torch.ops.tiles import build_tiles

# The tensors here are small: one intra-op thread keeps this test worker
# from competing with the suite's other workers for cores.
torch.set_num_threads(1)

F32_TOL, F64_TOL = 1e-5, 1e-13


def _random_coo(seed, m, n, density):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=density, random_state=rng,
                     data_rvs=lambda s: rng.normal(size=s)).tocoo()


def _fanout():
    A = _random_coo(2, 600, 800, 0.01).tocsr().tolil()
    A[:, 5] = 1.5
    return A.tocoo()


def _unbalanced():
    rng = np.random.default_rng(7)
    A = sp.coo_matrix((rng.normal(size=5000),
                       (rng.integers(0, 100, 5000),
                        rng.integers(0, 2000, 5000))), shape=(1000, 2000))
    A.sum_duplicates()
    return A


def _high_multiplicity():
    rng = np.random.default_rng(23)
    rows = np.repeat(np.arange(64), 40)
    A = sp.coo_matrix((rng.normal(size=len(rows)),
                       (rows, rng.integers(0, 2000, len(rows)))),
                      shape=(256, 2048))
    A.sum_duplicates()
    return A


def _tiny():
    return sp.coo_matrix((np.array([1.0, 2.0, 3.0]),
                          (np.array([0, 0, 1]), np.array([0, 1, 0]))),
                         shape=(130, 130))


# (name, matrix, m_pad, n_pad) -- the shapes of tests/test_lane_ell.py.
CASES = {
    "single_window": (lambda: _random_coo(1, 900, 1100, 0.01), 1024, 1280),
    "multi_window": (lambda: _random_coo(2, 900, 40000, 0.001), 1024, 40960),
    "dense_column_fanout": (_fanout, 640, 896),
    "unbalanced_rows": (_unbalanced, 1024, 2048),
    "tiny": (_tiny, 256, 256),
    "high_multiplicity": (_high_multiplicity, 256, 2048),
}


LAYOUTS = ["csr", "tiled"]


def _port(A, m_pad, n_pad, dtype, layout="csr"):
    M = csr_from_coo(A.row, A.col, A.data, m_pad, n_pad, dtype, "cpu")
    if layout == "tiled":
        M = M.with_tiles(build_tiles(M, strip_width=256, block_rows=96))
    return M


def _scipy_y(A, x, m_pad):
    y = np.zeros(m_pad)
    y[:A.shape[0]] = A.tocsr() @ x[:A.shape[1]].astype(np.float64)
    return y


def _assert_close(y, y_ref, tol):
    scale = max(1.0, float(np.abs(y_ref).max()))
    assert np.abs(np.asarray(y, np.float64) - y_ref).max() <= tol * scale


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_spmv_matches_scipy(case, layout):
    make, m_pad, n_pad = CASES[case]
    A = make()
    x = np.random.default_rng(0).normal(size=n_pad)
    y_ref = _scipy_y(A, x, m_pad)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        M = _port(A, m_pad, n_pad, dtype, layout)
        y = spmv(M, torch.as_tensor(x).to(dtype))
        assert y.dtype == dtype and y.shape == (m_pad,)
        _assert_close(y.numpy(), y_ref, tol)


@pytest.mark.parametrize("case", ["single_window", "multi_window",
                                  "dense_column_fanout", "unbalanced_rows",
                                  "tiny"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_matches_lane_spmv(case, layout):
    """f32: the aligned LaneELL kernel (lane_spmv, interpret mode)."""
    make, m_pad, n_pad = CASES[case]
    A = make()
    x = np.random.default_rng(0).normal(size=n_pad).astype(np.float32)
    tiles = schedule_lane_ell(A.row.astype(np.int64), A.col.astype(np.int64),
                              A.data, m_pad, n_pad)
    p = pack_tiles(tiles, n_pad, np.float32)
    y_jax = np.asarray(lane_spmv(jnp.asarray(x), p["idx1t"], p["idx2"],
                                 p["vals"], p["gbase"], p["wid"], p["G"],
                                 interpret=True))
    y = spmv(_port(A, m_pad, n_pad, torch.float32, layout),
             torch.as_tensor(x))
    y_ref = _scipy_y(A, x, m_pad)
    _assert_close(y.numpy(), y_ref, F32_TOL)
    _assert_close(y.numpy(), y_jax.astype(np.float64), F32_TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("phi", [1, 2, 4, 8])
def test_port_matches_thin_spmv(phi, layout):
    """f32: the packed thin LaneELL kernel (thin_spmv, interpret mode)."""
    case = "high_multiplicity" if phi in (1, 4) else "single_window"
    make, m_pad, n_pad = CASES[case]
    A = make()
    x = np.random.default_rng(0).normal(size=n_pad).astype(np.float32)
    tiles = schedule_thin(A.row.astype(np.int64), A.col.astype(np.int64),
                          A.data, m_pad, n_pad, phi=phi)
    p = pack_tiles(tiles, n_pad, np.float32)
    y_jax = np.asarray(thin_spmv(jnp.asarray(x), p["idx1t"], p["idx2"],
                                 p["invt"], p["vals"], p["gbase"], p["wid"],
                                 p["G"], p["phi"], interpret=True))
    y = spmv(_port(A, m_pad, n_pad, torch.float32, layout),
             torch.as_tensor(x))
    _assert_close(y.numpy(), _scipy_y(A, x, m_pad), F32_TOL)
    _assert_close(y.numpy(), y_jax.astype(np.float64), F32_TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["aligned", "thin"])
def test_port_f64_matches_df64_kernels(kind, layout):
    """f64: the compensated pair kernels (lane_spmv_df64, thin_spmv_df64)
    that the native-f64 build replaces."""
    A = _random_coo(3 if kind == "aligned" else 26, 900, 1100, 0.01)
    m_pad, n_pad = 1024, 1280
    x = np.random.default_rng(3).normal(size=n_pad)
    xh = x.astype(np.float32)
    xl = (x - xh.astype(np.float64)).astype(np.float32)
    rows, cols = A.row.astype(np.int64), A.col.astype(np.int64)
    if kind == "aligned":
        p = pack_tiles(schedule_lane_ell(rows, cols, A.data, m_pad, n_pad),
                       n_pad, np.float64)
        yh, yl = lane_spmv_df64(jnp.asarray(xh), jnp.asarray(xl),
                                p["idx1t"], p["idx2"], p["vals"],
                                p["vals_lo"], p["gbase"], p["wid"], p["G"],
                                interpret=True)
    else:
        p = pack_tiles(schedule_thin(rows, cols, A.data, m_pad, n_pad,
                                     phi=4), n_pad, np.float64)
        yh, yl = thin_spmv_df64(jnp.asarray(xh), jnp.asarray(xl),
                                p["idx1t"], p["idx2"], p["invt"], p["vals"],
                                p["vals_lo"], p["gbase"], p["wid"], p["G"],
                                p["phi"], interpret=True)
    y_jax = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    y = spmv(_port(A, m_pad, n_pad, torch.float64, layout),
             torch.as_tensor(x))
    _assert_close(y.numpy(), _scipy_y(A, x, m_pad), F64_TOL)
    _assert_close(y.numpy(), y_jax, F64_TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_port_matches_hybrid_lane_backend(dtype, layout):
    """The JAX spmv on with_backend(A, "lane") (aligned + thin tiles
    summed, df64 pairs in f64) against the port on the same padded COO."""
    from hprlp_tpu.ops.device_problem import build_device_problem
    from hprlp_tpu.ops.sparse import to_coo, with_backend
    from hprlp_tpu.ops.sparse import spmv as jax_spmv
    from hprlp_tpu.problem import LpProblem

    rng = np.random.default_rng(27)
    rows = [rng.integers(0, 256, 20000), rng.integers(256, 4000, 3000)]
    cols = [rng.integers(0, 2000, 20000), rng.integers(0, 30000, 3000)]
    A = sp.coo_matrix((rng.normal(size=23000),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(4000, 30000)).tocsr()
    A.sum_duplicates()
    x0 = rng.uniform(-1, 1, 30000)
    prob = LpProblem.from_arrays(A, A @ x0 - 1, A @ x0 + 1, x0 - 1, x0 + 1,
                                 rng.normal(size=30000))
    np_dtype = np.float32 if dtype == "f32" else np.float64
    lp, _ = build_device_problem(prob, dtype=np_dtype)
    x = rng.normal(size=lp.A.ncols).astype(np_dtype)
    y_lane = np.asarray(jax_spmv(with_backend(lp.A, "lane"), jnp.asarray(x)),
                        np.float64)
    r, c, v = to_coo(lp.A)
    t_dtype = torch.float32 if dtype == "f32" else torch.float64
    M = csr_from_coo(r, c, v, lp.A.nrows, lp.A.ncols, t_dtype, "cpu")
    if layout == "tiled":
        M = M.with_tiles(build_tiles(M, strip_width=1024, block_rows=512))
    y = spmv(M, torch.as_tensor(x)).numpy()
    y_ref = np.zeros(lp.A.nrows)
    np.add.at(y_ref, r, v * x[c].astype(np.float64))
    tol = F32_TOL if dtype == "f32" else F64_TOL
    _assert_close(y, y_ref, tol)
    _assert_close(y, y_lane, tol)


def test_cpu_spmv_does_not_launch_the_kernel():
    M = _port(_random_coo(1, 900, 1100, 0.01), 1024, 1280, torch.float32)
    csr_spmv.launches = 0
    spmv(M, torch.ones(1280))
    assert csr_spmv.launches == 0


def test_kernel_wrapper_refuses_cpu_and_foreign_devices():
    """No hidden fallback: the wrapper takes only CUDA tensors, and the
    dispatcher raises on a device it does not know."""
    M = _port(_tiny(), 256, 256, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        csr_spmv(M, torch.ones(256))
    with pytest.raises(ValueError, match="unsupported device"):
        spmv(M, torch.ones(256, device="meta"))


def test_build_without_nvcc_raises(monkeypatch):
    from hprlp_tpu_torch.ops import spmv as spmv_mod

    monkeypatch.setattr(spmv_mod.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setattr(spmv_mod, "library_path",
                        lambda source=None: "/nonexistent-cuda/lib.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        spmv_mod.build()


def test_int32_overflow_is_refused():
    with pytest.raises(ValueError, match="int32"):
        csr_from_numpy(np.array([0, 2**31]), np.zeros(0), np.zeros(0), 1, 1,
                       torch.float32, "cpu")


def test_threads_per_row_covers_mean_row_length():
    assert threads_per_row(0, 10) == 2
    assert threads_per_row(20 * 65536, 65536) == 32
    assert threads_per_row(10 * 131072, 131072) == 16
    assert threads_per_row(1000, 1) == 32
