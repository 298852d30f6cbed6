"""The "gather" backend's CSR kernel (csrc/spmv_csr.cu), its fused
single-LP halves, and the redesigned segsum study on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_spmv_csr_gpu.py

Tolerances: the kernel against its plain version on the plan
(ops/spmv.py::csr_spmv_plain, the same operations in the same order)
bitwise; against spmv_reference 1e-5 (f32) and 1e-12 (f64) times
max(1, max|y|), the sums running in another order; the fused halves and a
fused chunk bitwise against the kernel's store plus the plain ops; segsum
full 1e-5 times max(1, max|y|) against its plain version (the tensor
cores add the one-hot products in an order of their own).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.sparse import with_spmv_backend
from hprlp_tpu_torch.ops.spmv import (csr_cap, csr_spmv, csr_spmv_plain,
                                      row_blocks, spmv_reference,
                                      spmv_x_half, spmv_y_half)
from hprlp_tpu_torch.ops.spmv_variants import (segsum_onehot_plain,
                                               segsum_tiles, spmv_segsum)
from hprlp_tpu_torch.solver import chunk
from hprlp_tpu_torch.solver.graph import CapturedStep

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.float64]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
CSR_CAP = csr_cap(torch.float32)  # 2048 entries; f64's window is 1024

# The matrices of the card's and the CPU's tests
# (tests/test_torch_spmv_csr.py imports them).


def _random(seed, m, n, density):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=density, random_state=rng,
                     data_rvs=lambda k: rng.normal(size=k)).tocsr()


def _empty_rows():
    """Rows with entries only every 7th row, and a run of 900 empty rows:
    more than one block's worth of rows with nothing in them."""
    A = _random(3, 2000, 600, 0.02).tolil()
    for r in range(2000):
        if r % 7 or 600 <= r < 1500:
            A.rows[r], A.data[r] = [], []
    return A.tocsr()


def _dense_row():
    """One row with every column (5000 > CSR_CAP entries) among sparse
    ones, and a row of exactly CSR_CAP entries."""
    A = _random(4, 300, 5000, 0.002).tolil()
    A[17, :] = np.linspace(-1.0, 1.0, 5000)
    A[18, :CSR_CAP] = 0.5
    A[18, CSR_CAP:] = 0.0
    return A.tocsr()


def _skewed():
    """Zipf-like row lengths: most rows short, a few hundreds long."""
    rng = np.random.default_rng(5)
    lengths = np.minimum(rng.zipf(1.6, size=1500), 1200)
    rows = np.repeat(np.arange(1500), lengths)
    cols = rng.integers(0, 3000, size=rows.size)
    A = sp.coo_matrix((rng.normal(size=rows.size), (rows, cols)),
                      shape=(1500, 3000)).tocsr()
    A.sum_duplicates()
    return A


def _long_rows():
    """Two adjacent rows longer than CSR_CAP, one of CSR_CAP + 1, and
    short rows around them."""
    A = _random(6, 40, 6000, 0.001).tolil()
    A[10, :4500] = 1.25
    A[11, 100:6000] = -0.75
    A[30, :CSR_CAP + 1] = 2.0
    return A.tocsr()


def _tiny():
    return sp.csr_matrix((np.array([1.0, 2.0, 3.0]),
                          (np.array([0, 0, 1]), np.array([0, 1, 0]))),
                         shape=(3, 3))


CASES = {"random": lambda: _random(1, 700, 900, 0.01),
         "empty_rows": _empty_rows, "dense_row": _dense_row,
         "skewed": _skewed, "long_rows": _long_rows, "tiny": _tiny}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bench():
    from hprlp_tpu_torch.prof.problems import random_lp

    return random_lp(65536, 131072, 20, seed=2).A.tocsr()


def _matrix(case, dtype, device):
    cases = {**CASES, **MORE_HALF_CASES}
    A = _bench() if case == "bench" else cases[case]()
    C = A.tocoo()
    M = csr_from_coo(C.row, C.col, C.data, A.shape[0], A.shape[1], dtype,
                     device)
    return with_spmv_backend(M, "gather")


def _x(n, dtype, device, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=n),
                           device=device).to(dtype)


def _assert_close(y, y_ref, tol):
    scale = max(1.0, float(y_ref.abs().max())) if y_ref.numel() else 1.0
    err = float((y - y_ref).abs().max()) if y.numel() else 0.0
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["bench"] + sorted(CASES))
def test_kernel_matches_plain(cuda, case, dtype):
    """Bitwise the plain version on the plan, close to the contract; one
    launch per call; two launches bitwise equal."""
    M = _matrix(case, dtype, cuda)
    x = _x(M.ncols, dtype, cuda)
    before = csr_spmv.launches
    y = csr_spmv(M, x)
    y2 = csr_spmv(M, x)
    torch.cuda.synchronize()
    assert csr_spmv.launches == before + 2
    assert torch.equal(y, csr_spmv_plain(M, x))
    assert torch.equal(y, y2)
    _assert_close(y, spmv_reference(M, x), TOL[dtype])


def _half_operands(M, MT, dtype, device):
    """A square-ish set of operands for one x-half over MT's rows (y of
    M's rows) and one y-half over M's rows."""
    rng = np.random.default_rng(4)

    def vec(n, scale=1.0):
        return torch.as_tensor(rng.normal(size=n) * scale,
                               device=device).to(dtype)

    n, m = MT.nrows, M.nrows
    lo = vec(n)
    return {"y": vec(m), "x": vec(n), "last_x": vec(n), "c": vec(n),
            "l": lo, "u": lo + torch.abs(vec(n)), "AL": vec(m) - 1.0,
            "AU": vec(m) + 1.0, "last_y": vec(m),
            "sigma": torch.tensor(0.73, dtype=dtype, device=device),
            "lam_sigma": torch.tensor(2.9, dtype=dtype, device=device),
            "inner": torch.tensor(5, dtype=torch.int32, device=device)}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["random", "skewed", "long_rows",
                                  "dense_row", "empty_rows", "one_long_row",
                                  "unaligned", "many_blocks"])
def test_fused_halves_equal_store_plus_plain_ops(cuda, case, dtype):
    """spmv_x_half / spmv_y_half bitwise the kernel's store followed by the
    plain ops of solver/chunk.py (x_half_plain and y_half_plain on an LP
    whose matrices are on the gather backend), at several t."""
    from hprlp_tpu_torch.ops.device_problem import LpDevice

    M = _matrix(case, dtype, cuda)
    MT = with_spmv_backend(_transpose(M), "gather")
    o = _half_operands(M, MT, dtype, cuda)
    lp = LpDevice(A=M, AT=MT, AL=o["AL"], AU=o["AU"], c=o["c"], l=o["l"],
                  u=o["u"])
    for t in (0, 3, 147):
        h = chunk.Halpern(o["inner"], t, dtype)
        x_new, x_hat = spmv_x_half(MT, o["y"], o["x"], o["last_x"], o["c"],
                                   o["l"], o["u"], o["sigma"], o["inner"],
                                   t)
        xp, xhp = chunk.x_half_plain(lp, o["x"], o["y"], o["last_x"],
                                     o["sigma"], h)
        y_new = spmv_y_half(M, x_hat, o["y"], o["last_y"], o["AL"], o["AU"],
                            o["lam_sigma"], o["inner"], t)
        yp = chunk.y_half_plain(lp, o["y"], xhp, o["last_y"],
                                o["lam_sigma"], h)
        torch.cuda.synchronize()
        assert torch.equal(x_new, xp) and torch.equal(x_hat, xhp), t
        assert torch.equal(y_new, yp), t
        # The dispatch takes the fused kernel on the card.
        before = (spmv_x_half.launches, spmv_y_half.launches)
        chunk.x_half(lp, o["x"], o["y"], o["last_x"], o["sigma"], h)
        chunk.y_half(lp, o["y"], x_hat, o["last_y"], o["lam_sigma"], h)
        assert (spmv_x_half.launches, spmv_y_half.launches) == (
            before[0] + 1, before[1] + 1)


def _transpose(M):
    """M^T as a CsrMatrix on M's device (scipy on the host)."""
    import scipy.sparse as sp

    A = sp.csr_matrix((M.vals.double().cpu().numpy(),
                       M.indices.cpu().numpy(), M.indptr.cpu().numpy()),
                      shape=(M.nrows, M.ncols)).T.tocoo()
    return csr_from_coo(A.row, A.col, A.data, M.ncols, M.nrows, M.dtype,
                        M.device)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_fused_chunk_replay_equals_eager_and_plain(cuda, dtype):
    """A 150-iteration run_chunk on the gather backend: fused halves
    (2 launches a middle iteration) bitwise equal to the plain halves, and
    its CUDA graph's replay bitwise equal to the eager run."""
    from hprlp_tpu_torch.prof import prof_loop
    from hprlp_tpu_torch.prof.problems import random_lp

    loop = prof_loop.Loop(random_lp(4096, 8192, 12, seed=3), dtype,
                          graph=False, backend="gather")
    loop.run(1)
    args = (loop.lp, loop.scal, loop.state, loop.sigma, loop.lam,
            torch.tensor(False, device=cuda), 150)
    before = (spmv_x_half.launches, spmv_y_half.launches)
    st_f, m_f = chunk.run_chunk(*args)
    assert (spmv_x_half.launches - before[0],
            spmv_y_half.launches - before[1]) == (148, 148)
    fused_x, fused_y = chunk.x_half, chunk.y_half
    try:
        chunk.x_half, chunk.y_half = chunk.x_half_plain, chunk.y_half_plain
        st_p, m_p = chunk.run_chunk(*args)
    finally:
        chunk.x_half, chunk.y_half = fused_x, fused_y
    step = CapturedStep(lambda: chunk.run_chunk(*args))
    step.replay()
    st_g, m_g = step.out
    torch.cuda.synchronize()
    for f in ("x", "y", "x_bar", "y_bar", "z_bar", "y_obj", "inner"):
        assert torch.equal(getattr(st_f, f), getattr(st_p, f)), f
        assert torch.equal(getattr(st_f, f), getattr(st_g, f)), f
    for k in m_f:
        assert torch.equal(m_f[k], m_p[k]) and torch.equal(m_f[k], m_g[k]), k


def test_fused_halves_reject_bad_arguments(cuda):
    M = _matrix("random", torch.float32, cuda)
    MT = with_spmv_backend(_transpose(M), "gather")
    o = _half_operands(M, MT, torch.float32, cuda)
    with pytest.raises(TypeError, match="int32"):
        spmv_x_half(MT, o["y"], o["x"], o["last_x"], o["c"], o["l"], o["u"],
                    o["sigma"], o["inner"].long(), 0)
    with pytest.raises(ValueError, match="shape"):
        spmv_y_half(M, o["x"], o["y"], o["last_y"], o["AL"][1:], o["AU"],
                    o["lam_sigma"], o["inner"], 0)
    with pytest.raises(TypeError):
        spmv_y_half(M, o["x"], o["y"], o["last_y"], o["AL"], o["AU"],
                    o["lam_sigma"].double(), o["inner"], 0)


# More plans for the fused halves: one long row's block alone, windows
# that start at every offset of a vector, and a plan of several waves of
# row blocks (also cut into a rank's row shard).

def _one_long_row():
    """One row of 3 * CSR_CAP + 5 entries and nothing else: a plan of one
    long row's block."""
    n = 3 * CSR_CAP + 5
    return sp.csr_matrix((np.linspace(-2.0, 2.0, n), (np.zeros(n, int),
                                                      np.arange(n))),
                         shape=(1, n))


def _unaligned():
    """Row lengths 1, 2, 3, 5, 7 in turn, so row blocks' windows start at
    every offset within a 16-byte vector, and nnz % 4 == 3: the arrays'
    last vector is partial."""
    rng = np.random.default_rng(13)
    lengths = np.resize([1, 2, 3, 5, 7], 2400)
    lengths[-1] += 3 - int(lengths.sum()) % 4
    rows = np.repeat(np.arange(lengths.size), lengths)
    cols = np.arange(rows.size) * 37 % 1500  # distinct within a row
    A = sp.coo_matrix((rng.normal(size=rows.size), (rows, cols)),
                      shape=(lengths.size, 1500)).tocsr()
    assert A.nnz % 4 == 3
    return A


def _many_blocks():
    """300,000 rows of 3-6 entries and four rows longer than CSR_CAP among
    them: several waves of row blocks on an H100, long rows' blocks among
    them."""
    rng = np.random.default_rng(17)
    m, n = 300_000, 20_000
    lengths = rng.integers(3, 7, size=m)
    for r in (5, 77_777, 150_001, 299_998):
        lengths[r] = 2 * CSR_CAP + 11 + r % 7
    rows = np.repeat(np.arange(m), lengths)
    cols = rng.integers(0, n, size=rows.size)
    A = sp.coo_matrix((rng.normal(size=rows.size), (rows, cols)),
                      shape=(m, n)).tocsr()
    A.sum_duplicates()
    return A


MORE_HALF_CASES = {"one_long_row": _one_long_row, "unaligned": _unaligned,
                   "many_blocks": _many_blocks}


def _row_slice(M, r0, r1):
    """Rows [r0, r1) of M as a rank of a row-sharded mesh holds them: its
    own arrays (copied, 16-byte aligned) and its own plan."""
    import dataclasses

    e0, e1 = int(M.indptr[r0]), int(M.indptr[r1])
    S = dataclasses.replace(
        M, indptr=(M.indptr[r0:r1 + 1] - e0).contiguous(),
        indices=M.indices[e0:e1].clone(), vals=M.vals[e0:e1].clone(),
        nrows=r1 - r0, blocks=None, tiles=None, dense=None)
    return dataclasses.replace(S, blocks=row_blocks(S))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_fused_halves_on_a_row_shard(cuda, dtype):
    """spmv_x_half / spmv_y_half over a rank's rows [r0, r1) of A^T and A,
    as matrices of their own with their own plans and the row operands
    views at r0, bitwise the plain halves on the same rows, at t = 0 and
    5, one launch each."""
    from hprlp_tpu_torch.ops.device_problem import LpDevice

    M = _matrix("many_blocks", dtype, cuda)
    MT = with_spmv_backend(_transpose(M), "gather")
    o = _half_operands(M, MT, dtype, cuda)
    x_hat = _x(M.ncols, dtype, cuda, seed=3)
    xs, ys = slice(6_001, 13_333), slice(100_003, 211_117)
    M, MT = _row_slice(M, ys.start, ys.stop), _row_slice(MT, xs.start,
                                                        xs.stop)
    xr = tuple(o[k][xs] for k in ("x", "last_x", "c", "l", "u"))
    yr = tuple(o[k][ys] for k in ("y", "last_y", "AL", "AU"))
    lp = LpDevice(A=M, AT=MT, AL=yr[2], AU=yr[3], c=xr[2], l=xr[3],
                  u=xr[4])
    for t in (0, 5):
        h = chunk.Halpern(o["inner"], t, dtype)
        before = (spmv_x_half.launches, spmv_y_half.launches)
        x_new, x_h = spmv_x_half(MT, o["y"], *xr, o["sigma"], o["inner"], t)
        y_new = spmv_y_half(M, x_hat, *yr, o["lam_sigma"], o["inner"], t)
        xp, xhp = chunk.x_half_plain(lp, xr[0], o["y"], xr[1], o["sigma"], h)
        yp = chunk.y_half_plain(lp, yr[0], x_hat, yr[1], o["lam_sigma"], h)
        torch.cuda.synchronize()
        assert (spmv_x_half.launches, spmv_y_half.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(x_new, xp) and torch.equal(x_h, xhp), t
        assert torch.equal(y_new, yp), t


@pytest.mark.parametrize("case", ["bench", "random", "empty_rows",
                                  "skewed", "long_rows"])
def test_segsum_matches_plain(cuda, case):
    """segsum full (one-hot tensor-core row sums on the tiles) against its
    plain version and the contract; one launch per call."""
    M = _matrix(case, torch.float32, cuda)
    T = segsum_tiles(M)
    x = _x(M.ncols, torch.float32, cuda, seed=2)
    before = spmv_segsum.launches
    y = spmv_segsum(M, x, "full", tiles=T)
    torch.cuda.synchronize()
    assert spmv_segsum.launches == before + 1
    _assert_close(y, segsum_onehot_plain(T, x), 1e-5)
    _assert_close(y, spmv_reference(M, x), 1e-5)
