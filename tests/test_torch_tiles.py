"""The column-strip tiles of the main-path SpMV (hprlp_tpu_torch/ops/tiles.py)
and their plain version, on the CPU.

The kernel itself (csrc/spmv_tiled.cu) runs only on the card
(tests/test_torch_tiles_gpu.py, whose edge cases this file shares).  Here:
the layout against the CSR it came from, the plain version against scipy,
against the CSR plain version (bitwise: both sum each row in column order
with index_add_) and against the Pallas TPU kernels it replaces
(interpret mode), and a numpy emulation of the kernel's warp sums on the
same tiles, which also checks that no row is written twice in one step.

Tolerances: 1e-5 * max|y| in f32 and 1e-13 * max|y| in f64 -- the
summation order differs between column order, LaneELL tiles, scipy and
the kernel's segmented scan.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hprlp_tpu.ops.lane_ell import schedule_lane_ell, schedule_thin
from hprlp_tpu.ops.pallas_spmv import (lane_spmv, lane_spmv_df64, pack_tiles,
                                       thin_spmv, thin_spmv_df64)
from hprlp_tpu_torch.ops.device_problem import (attach_tiles,
                                                build_device_problem,
                                                csr_from_coo)
from hprlp_tpu_torch.ops.sparse import spmv
from hprlp_tpu_torch.ops.spmv import (HALF_STAGES, MAIN_STAGE, TILED_STAGES,
                                      _partials, check_tiled_layout,
                                      cluster_slots, group_sum_kernel,
                                      spmv_reference, tiled_spmv)
from hprlp_tpu_torch.ops.tiles import (CLUSTER, MAX_BLOCK_ROWS, SENTINEL_ROW,
                                       SMEM_BYTES, WARPS, build_tiles,
                                       smem_bytes, tiled_spmv_reference,
                                       vec_width)
from hprlp_tpu_torch.prof.timing import tiled_half_bytes
from test_torch_tiles_gpu import (CASES, GROUP_CASES, group_case_shape,
                                  make_case, make_group_case)

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.float64]
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
NP = {torch.float32: np.float32, torch.float64: np.float64}


def _case(name, dtype):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", sp.SparseEfficiencyWarning)
        return make_case(name, dtype, "cpu")


def _group_case(name, dtype):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", sp.SparseEfficiencyWarning)
        return make_group_case(name, dtype, "cpu")


def _assert_close(y, y_ref, tol):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    scale = max(1.0, float(np.abs(y_ref).max())) if y_ref.size else 1.0
    assert np.abs(y - y_ref).max(initial=0.0) <= tol * scale


def _scipy_y(M, x):
    ip, ix, v = (t.numpy() for t in (M.indptr, M.indices, M.vals))
    S = sp.csr_matrix((v.astype(np.float64), ix, ip),
                      shape=(M.nrows, M.ncols))
    return S @ x.numpy().astype(np.float64)


def _keys(T):
    return T.keys.numpy().view(np.uint32)


def emulate_kernel(T, x):
    """The kernel's arithmetic in numpy: per block, strip and warp run,
    steps of 32 lanes x VEC entries, each lane's row sums, the segmented
    warp scan on the row key, and the carry of the open row across steps
    (csrc/spmv_tiled.cu sum_step); then the strip groups' partials summed
    in group order (group_sum_kernel).  Asserts that the rows a step
    writes are distinct and that a row has one warp per strip."""
    dt = NP[T.dtype]
    n = vec_width(T.dtype)
    vals, keys = T.vals.numpy(), _keys(T)
    runs, starts = T.runs.numpy(), T.row_start.numpy()
    xn = x.numpy()
    W, Kg, C = T.strip_width, T.group_strips, T.n_chunks
    lanes = np.arange(32)

    def up(a, d):
        return np.where(lanes >= d, np.roll(a, d), a)

    ys = np.zeros((T.n_blocks, max(T.max_block_rows, 1)), dt)
    owner = {}
    nonempty = np.flatnonzero(np.diff(runs))
    b_, w_, l_ = nonempty // (Kg * WARPS), nonempty // Kg % WARPS, nonempty % Kg
    for b, l, w in sorted(zip(b_, l_, w_)):  # strip by strip, as the kernel
        run = (b * WARPS + w) * Kg + l
        beg, end = runs[run], runs[run + 1]
        s = b // C * Kg + l
        xs = xn[s * W:(s + 1) * W]

        def add(rows, sums):
            keep = rows != SENTINEL_ROW
            rows, sums = rows[keep], sums[keep]
            assert len(np.unique(rows)) == len(rows), "row written twice"
            ys[b, rows] += sums

        carry_row, carry = SENTINEL_ROW, dt(0)
        for p in range(beg, end, 32 * n):
            idx = p + lanes[:, None] * n + np.arange(n)
            ok = idx < end
            idx = np.minimum(idx, len(vals) - 1)
            v = np.where(ok, vals[idx], dt(0)).astype(dt)
            k = np.where(ok, keys[idx], np.uint32(SENTINEL_ROW << 16))
            r, c = (k >> 16).astype(np.int64), (k & 0xFFFF)
            for row in np.unique(r[r != SENTINEL_ROW]):
                assert owner.setdefault((b, s, row), w) == w, "shared row"
            prod = (v * xs[np.minimum(c, len(xs) - 1)]).astype(dt)
            if carry_row != r[0, 0]:
                add(np.array([carry_row]), np.array([carry], dt))
                carry_row, carry = SENTINEL_ROW, dt(0)
            last = r[:, -1]
            a = np.zeros(32, dt)
            for j in range(n):
                a = np.where(r[:, j] == last, a + prod[:, j], a)
            S = a
            d = 1
            while d < 32:
                S = np.where((lanes >= d) & (up(last, d) == last),
                             S + up(S, d), S).astype(dt)
                d *= 2
            S = np.where(last == carry_row, carry + S, S).astype(dt)
            cur = np.where(up(last, 1) == r[:, 0], up(S, 1), dt(0))
            cur[0] = carry if r[0, 0] == carry_row else dt(0)
            cur = cur.astype(dt)
            for j in range(n - 1):
                cur = (cur + prod[:, j]).astype(dt)
                closes = r[:, j] != r[:, j + 1]
                add(r[closes, j], cur[closes])
                cur = np.where(closes, dt(0), cur)
            nxt = np.where(lanes < 31, np.roll(r[:, 0], -1), -1)
            closes = (lanes < 31) & (nxt != last)
            add(last[closes], S[closes])
            carry_row, carry = last[31], S[31]
        add(np.array([carry_row]), np.array([carry], dt))
    part = np.zeros((T.n_groups, T.nrows), dt)
    for b in range(T.n_blocks):
        c = b % C
        part[b // C, starts[c]:starts[c + 1]] = ys[b, :starts[c + 1] - starts[c]]
    y = part[0]
    for g in range(1, T.n_groups):
        y = (y + part[g]).astype(dt)
    return y


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_scipy(case, dtype):
    M, T, x = _case(case, dtype)
    y = tiled_spmv_reference(T, x)
    assert y.shape == (M.nrows,) and y.dtype == dtype
    _assert_close(y.numpy(), _scipy_y(M, x), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_csr_reference_bitwise(case, dtype):
    """Both plain versions index_add_ each row's products in increasing
    column order, and the CPU's index_add_ adds sequentially."""
    M, T, x = _case(case, dtype)
    assert torch.equal(tiled_spmv_reference(T, x), spmv_reference(M, x))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_matches_reference(case, dtype):
    _, T, x = _case(case, dtype)
    _assert_close(emulate_kernel(T, x), tiled_spmv_reference(T, x).numpy(),
                  TOL[dtype])


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiles_round_trip_to_the_csr(case):
    """tiles -> COO (padding dropped) is the CSR, entry for entry, and
    perm sends each CSR entry to its tile."""
    M, T, _ = _case(case, torch.float64)
    order, row, col = T.coo
    assert torch.equal(torch.sort(order).values, torch.arange(len(order)))
    real = row < T.nrows
    S = sp.coo_matrix((T.vals[order].numpy()[real.numpy()],
                       (row[real].numpy(), col[real].numpy())),
                      shape=(M.nrows, M.ncols)).tocsr()
    S.sort_indices()
    assert np.array_equal(S.indptr, M.indptr.numpy())
    assert np.array_equal(S.indices, M.indices.numpy())
    assert np.array_equal(S.data, M.vals.numpy())
    assert int(real.sum()) == M.nnz
    assert torch.equal(T.vals[T.perm], M.vals)
    where = torch.empty_like(order)
    where[order] = torch.arange(len(order))
    assert torch.equal(row[where[T.perm]],
                       torch.repeat_interleave(
                           torch.arange(M.nrows),
                           (M.indptr[1:] - M.indptr[:-1]).long()))
    assert torch.equal(col[where[T.perm]], M.indices.long())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_invariants(case, dtype):
    """What the kernel relies on: whole 16-byte loads per run, padding on
    the sentinel row at a run's end, rows sorted within a run, blocks a
    multiple of the cluster, strips and y inside shared memory."""
    M, T, _ = _case(case, dtype)
    n = vec_width(dtype)
    runs = T.runs.numpy().astype(np.int64)
    assert T.n_chunks % CLUSTER == 0
    assert T.n_blocks == T.n_groups * T.n_chunks
    assert (T.n_groups - 1) * T.group_strips < T.n_strips \
        <= T.n_groups * T.group_strips or T.n_strips == 0
    assert T.strip_width % 32 == 0 and T.n_strips * T.strip_width >= M.ncols
    assert (T.n_strips - 1) * T.strip_width < max(M.ncols, 1)
    assert T.smem_bytes <= SMEM_BYTES
    assert T.max_block_rows <= MAX_BLOCK_ROWS
    assert np.all(runs % n == 0) and np.all(np.diff(runs) >= 0)
    assert runs[-1] == T.vals.shape[0]
    starts = T.row_start.numpy()
    assert starts[0] == 0 and starts[-1] == M.nrows
    assert np.all(np.diff(starts) >= 0)
    rib = (_keys(T) >> 16).astype(np.int64)
    for lo, hi in zip(runs[:-1], runs[1:]):
        r = rib[lo:hi]
        pad = r == SENTINEL_ROW
        if pad.any():  # padding only at the end, fewer than one load
            first = int(np.argmax(pad))
            assert pad[first:].all() and hi - lo - first < n
        assert np.all(np.diff(r[~pad]) >= 0)
    assert np.all(T.vals.numpy()[rib == SENTINEL_ROW] == 0)


@pytest.mark.parametrize("kw", [{"strip_width": 64}, {"block_rows": 16},
                                {"strip_width": 32, "block_rows": 3}, {},
                                {"strip_width": 64, "strip_groups": 5},
                                {"strip_width": 128, "strip_groups": 2,
                                 "block_rows": 40}])
def test_forced_strips_and_blocks(kw):
    """Many strips and blocks at a small size give the same y."""
    M, _, x = _case("padding_rows", torch.float64)
    T = build_tiles(M, **kw)
    if "strip_width" in kw:
        assert T.n_strips == -(-M.ncols // kw["strip_width"])
    if "block_rows" in kw:
        assert T.max_block_rows <= kw["block_rows"]
        assert T.n_chunks >= M.nrows // kw["block_rows"]
    if "strip_groups" in kw:
        assert T.n_groups == kw["strip_groups"]
    assert torch.equal(tiled_spmv_reference(T, x), spmv_reference(M, x))
    _assert_close(emulate_kernel(T, x), _scipy_y(M, x), TOL[torch.float64])


def test_default_strip_fills_shared_memory():
    """Beyond one strip, W is the largest multiple of 32 for which two
    strips and y fit; a narrow matrix gets one strip of all its columns."""
    rng = np.random.default_rng(3)
    n = 200_000
    A = sp.random(4096, n, density=5e-4, random_state=rng).tocoo()
    for dtype in DTYPES:
        M = csr_from_coo(A.row, A.col, A.data, 4096, n, dtype, "cpu")
        T = build_tiles(M)
        v = M.vals.element_size()
        W, R = T.strip_width, T.max_block_rows
        assert T.n_strips > 1 and T.smem_bytes <= SMEM_BYTES
        assert smem_bytes(W, 2, R, v) <= SMEM_BYTES < smem_bytes(W + 32, 2,
                                                                 R, v)
    T = build_tiles(_case("padding_rows", torch.float32)[0])
    assert T.n_strips == 1 and T.strip_width == 1280


@pytest.mark.parametrize("kw, match", [
    ({"block_rows": MAX_BLOCK_ROWS + 1}, "16-bit"),
    ({"block_rows": 0}, "block_rows"),
    ({"strip_width": 65568}, "16-bit"),
    ({"strip_width": 48}, "multiple of 32"),
    ({"strip_groups": 0}, "strip_groups"),
])
def test_16_bit_overflow_is_refused(kw, match):
    M, _, _ = _case("random", torch.float32)
    with pytest.raises(ValueError, match=match):
        build_tiles(M, **kw)


def test_shared_memory_overflow_is_refused():
    """Two f64 strips of 65536 columns need 1 MiB of shared memory."""
    M, _, _ = _case("random", torch.float64)
    M = dataclasses.replace(M, ncols=200_000)
    with pytest.raises(ValueError, match="shared memory"):
        build_tiles(M, strip_width=65536)


def test_misaligned_x_is_refused():
    _, T, x = _case("random", torch.float32)
    buf = torch.zeros(T.ncols + 1)
    with pytest.raises(ValueError, match="16-byte"):
        check_tiled_layout(T, buf[1:])
    with pytest.raises(ValueError, match="shape"):
        check_tiled_layout(T, buf)
    with pytest.raises(TypeError):
        check_tiled_layout(T, x.double())
    check_tiled_layout(T, x)
    with pytest.raises(ValueError, match="CUDA"):
        tiled_spmv(T, x)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_retile_after_scaling(dtype):
    """Tiles built on the unscaled structure take the scaled values by
    perm, and equal tiles built on the scaled matrix."""
    from hprlp_tpu_torch.prof.problems import random_lp
    from hprlp_tpu_torch.solver.scaling import scale_problem

    lp, _ = build_device_problem(random_lp(300, 500, 6, seed=1),
                                 dtype=dtype)
    raw = (build_tiles(lp.A), build_tiles(lp.AT))
    scaled, _ = scale_problem(lp)
    assert scaled.A.tiles is None and scaled.AT.tiles is None
    tiled = attach_tiles(scaled, *raw)
    for M, T in ((tiled.A, tiled.A.tiles), (tiled.AT, tiled.AT.tiles)):
        fresh = build_tiles(M)
        assert torch.equal(T.vals, fresh.vals)
        assert torch.equal(T.keys, fresh.keys)
        x = torch.as_tensor(np.random.default_rng(0).normal(size=M.ncols)
                            ).to(dtype)
        assert torch.equal(spmv(M, x), spmv_reference(M, x))
    with pytest.raises(ValueError, match="retile"):
        raw[0].retile(lp.A.vals[:-1])


def test_with_vals_drops_the_tiles():
    M, T, x = _case("random", torch.float32)
    Mt = M.with_tiles(T)
    assert Mt.tiles is T
    assert Mt.with_vals(2 * M.vals).tiles is None
    with pytest.raises(ValueError, match="another matrix"):
        M.with_tiles(build_tiles(_case("empty_rows", torch.float32)[0]))


def test_cpu_solve_runs_the_tiled_plain_version(monkeypatch):
    """The CPU solve takes the same route as the card: tiles attached after
    scaling, every SpMV on them."""
    import hprlp_tpu_torch as ht
    from hprlp_tpu_torch.ops import sparse

    calls = {"tiled": 0, "csr": 0}

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(sparse, "tiled_spmv_reference",
                        count("tiled", sparse.tiled_spmv_reference))
    monkeypatch.setattr(sparse, "spmv_reference",
                        count("csr", sparse.spmv_reference))
    res = ht.solve_problem(
        ht.LpProblem.from_arrays(np.array([[1.0, 2.0], [3.0, 1.0]]),
                                 [-np.inf] * 2, [10.0, 12.0], [0.0, 0.0],
                                 [np.inf] * 2, [-3.0, -5.0]),
        ht.Parameters(verbose=False), device="cpu")
    assert res.status == "OPTIMAL" and res.spmv_backend == "tiled"
    assert calls["tiled"] > 0 and calls["csr"] == 0


def _pallas_case(seed, m, n, density, m_pad, n_pad):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocoo()
    return A, m_pad, n_pad


@pytest.mark.parametrize("kw", [{}, {"strip_width": 128, "block_rows": 64}])
@pytest.mark.parametrize("kernel", ["lane", "thin"])
def test_matches_pallas_f32(kernel, kw):
    """f32: lane_spmv / thin_spmv (interpret mode) on the same matrix."""
    A, m_pad, n_pad = _pallas_case(1, 900, 1100, 0.01, 1024, 1280)
    x = np.random.default_rng(0).normal(size=n_pad).astype(np.float32)
    rows, cols = A.row.astype(np.int64), A.col.astype(np.int64)
    if kernel == "lane":
        p = pack_tiles(schedule_lane_ell(rows, cols, A.data, m_pad, n_pad),
                       n_pad, np.float32)
        y_jax = lane_spmv(jnp.asarray(x), p["idx1t"], p["idx2"], p["vals"],
                          p["gbase"], p["wid"], p["G"], interpret=True)
    else:
        p = pack_tiles(schedule_thin(rows, cols, A.data, m_pad, n_pad,
                                     phi=2), n_pad, np.float32)
        y_jax = thin_spmv(jnp.asarray(x), p["idx1t"], p["idx2"], p["invt"],
                          p["vals"], p["gbase"], p["wid"], p["G"], p["phi"],
                          interpret=True)
    M = csr_from_coo(A.row, A.col, A.data, m_pad, n_pad, torch.float32, "cpu")
    T = build_tiles(M, **kw)
    y = tiled_spmv_reference(T, torch.as_tensor(x)).numpy()
    _assert_close(y, np.asarray(y_jax, np.float64), TOL[torch.float32])
    _assert_close(emulate_kernel(T, torch.as_tensor(x)),
                  np.asarray(y_jax, np.float64), TOL[torch.float32])


@pytest.mark.parametrize("kernel", ["lane", "thin"])
def test_matches_pallas_df64(kernel):
    """f64: lane_spmv_df64 / thin_spmv_df64 (interpret mode), whose
    (hi, lo) pairs the native-f64 build replaces."""
    A, m_pad, n_pad = _pallas_case(3, 900, 1100, 0.01, 1024, 1280)
    x = np.random.default_rng(3).normal(size=n_pad)
    xh = x.astype(np.float32)
    xl = (x - xh.astype(np.float64)).astype(np.float32)
    rows, cols = A.row.astype(np.int64), A.col.astype(np.int64)
    if kernel == "lane":
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
    M = csr_from_coo(A.row, A.col, A.data, m_pad, n_pad, torch.float64, "cpu")
    T = build_tiles(M, strip_width=256, block_rows=128)
    y = tiled_spmv_reference(T, torch.as_tensor(x)).numpy()
    _assert_close(y, y_jax, TOL[torch.float64])
    _assert_close(y, _scipy_y(M, torch.as_tensor(x)), TOL[torch.float64])


def test_prof_tiled_needs_a_card(capsys):
    """The design study measures on the card only; without one it says so
    and returns 2 rather than timing the CPU."""
    from hprlp_tpu_torch.prof import prof_tiled

    assert prof_tiled.main(["--size", "bench"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# --- the main stage: strip groups as one cluster ---------------------------

def test_stage_table_names_the_cluster_route_main():
    """The main stage is the cluster of the G strip groups (code -1 in
    csrc/spmv_tiled.cu); block_x (code 1, the previous design) stays, and
    the fused halves run on those two only."""
    assert MAIN_STAGE == "group_cluster"
    assert TILED_STAGES == {"group_cluster": -1, "global_x": 0,
                            "block_x": 1, "cluster2_x": 2, "cluster4_x": 4,
                            "cluster8_x": 8}
    assert HALF_STAGES == ("group_cluster", "block_x")
    assert cluster_slots("cpu") is None


@pytest.mark.parametrize("stage", sorted(TILED_STAGES))
@pytest.mark.parametrize("case", ["random", "strip_groups"])
def test_partials_only_off_the_main_stage(case, stage):
    """No partial y is allocated on the main stage; every other stage takes
    G * nrows partials at G > 1, none at G = 1.  Allocating counts no
    group-sum pass: only a launch that succeeded does."""
    _, T, x = _case(case, torch.float32)
    before = group_sum_kernel.launches
    part = _partials(T, x, stage)
    if T.n_groups == 1 or stage == MAIN_STAGE:
        assert part is None
    else:
        assert part.shape == (T.n_groups * T.nrows,)
        assert part.dtype == x.dtype
    assert group_sum_kernel.launches == before
    assert (T.n_groups > 1) == (case == "strip_groups")


@pytest.mark.parametrize("half", ["x", "y"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["random", "strip_groups", "G7"])
def test_tiled_half_bytes_count_partials_on_block_x_only(case, dtype, half):
    """The byte model: the main stage streams no partials; block_x streams
    2 G nrows values more at G > 1, the same at G = 1."""
    _, T, _ = (_group_case(case, dtype) if case in GROUP_CASES
               else _case(case, dtype))
    v = torch.empty((), dtype=dtype).element_size()
    main = tiled_half_bytes(T, dtype, half)
    assert main == tiled_half_bytes(T, dtype, half, MAIN_STAGE)
    extra = 2 * T.n_groups * T.nrows * v if T.n_groups > 1 else 0
    assert tiled_half_bytes(T, dtype, half, "block_x") == main + extra
    rows = 7 if half == "x" else 5
    assert main == (T.vals.shape[0] * (v + 4) + (T.runs.numel()
                    + T.row_start.numel()) * 4 + T.ncols * v
                    + rows * T.nrows * v + v + 4)


def test_group_cases_cover_the_cluster_edges():
    """The card's cluster cases (tests/test_torch_tiles_gpu.py GROUP_CASES)
    hold G = 1 .. 8 as asked, uneven groups (3, 5, 6, 7 among them), chunks of fewer
    rows than G, and empty padded chunks; their plain y is the CSR one."""
    seen = {"uneven": set(), "rows_below_G": set(), "padded": set()}
    for name in GROUP_CASES:
        M, T, x = _group_case(name, torch.float64)
        G, rows, empty = group_case_shape(T)
        assert G == GROUP_CASES[name][0], name
        if T.n_strips % T.group_strips:
            seen["uneven"].add(G)
        if rows < G:
            seen["rows_below_G"].add(G)
        if empty:
            seen["padded"].add(G)
        assert torch.equal(tiled_spmv_reference(T, x), spmv_reference(M, x))
    assert {3, 5, 6, 7} <= seen["uneven"]
    assert seen["rows_below_G"] and len(seen["padded"]) >= 4


@pytest.mark.parametrize("case", sorted(CASES))
def test_live_chunks_are_the_chunks_before_the_padding(case):
    """live_chunks counts the chunks with rows, which come first; the rest
    are the empty padding up to a multiple of CLUSTER."""
    _, T, _ = _case(case, torch.float32)
    n = (T.row_start[1:] - T.row_start[:-1]).numpy()
    assert 1 <= T.live_chunks <= T.n_chunks
    assert (n[:T.live_chunks] > 0).all() and (n[T.live_chunks:] == 0).all()
    assert T.n_chunks - T.live_chunks < CLUSTER


SLOTS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


@pytest.mark.parametrize("G", [2, 3, 5, 8])
def test_slots_cap_the_chunks_at_the_resident_clusters(G):
    """With the card's resident clusters (an H100's counts at full shared
    memory; a smaller table too), a tiling of G groups takes at most
    slots[G] chunks and G stays; its y is the CSR one; without slots the
    layout is the CPU's (build_tiles with no argument), bitwise."""
    M, _, x = _group_case(f"G{G}", torch.float64)
    plain = build_tiles(M, strip_width=64, strip_groups=G)
    again = build_tiles(M, strip_width=64, strip_groups=G, slots=None)
    for f in ("vals", "keys", "runs", "row_start"):
        assert torch.equal(getattr(plain, f), getattr(again, f)), f
    for slots in (SLOTS, {g: 1 for g in SLOTS}):
        T = build_tiles(M, strip_width=64, strip_groups=G, slots=slots)
        assert T.n_groups == G and T.live_chunks <= slots[G]
        assert torch.equal(tiled_spmv_reference(T, x), spmv_reference(M, x))
    small = build_tiles(M, strip_width=64, strip_groups=G,
                        slots={g: 1 for g in SLOTS})
    assert small.live_chunks == 1 < plain.live_chunks


def test_slots_cut_the_chunks_for_the_groups_that_run():
    """Eleven strips asked into 8 groups run as 6 (two strips each): with
    slots the chunks are cut again for 6 groups (slots[6] of them), not
    left at slots[8]; without slots the chunk count stays the CPU's."""
    rng = np.random.default_rng(5)
    A = sp.random(3000, 11 * 64, density=0.05, random_state=rng).tocoo()
    M = csr_from_coo(A.row, A.col, A.data, 3000, 11 * 64, torch.float32,
                     "cpu")
    slots = {g: 9 - g for g in range(1, 9)}  # 8: 1, 6: 3
    T = build_tiles(M, strip_width=64, strip_groups=8, slots=slots)
    assert (T.n_groups, T.group_strips) == (6, 2)
    assert T.live_chunks == slots[6]
    plain = build_tiles(M, strip_width=64, strip_groups=8)
    assert plain.n_groups == 6
    assert plain.live_chunks == max(1, -(-M.nnz // 4096) // 8)


def test_slots_take_a_group_fewer_for_a_short_last_group():
    """A default of 4 groups over 13 strips leaves the last group one strip
    against the others' four: with slots the tiles take 3 groups (5, 5
    and 3 strips); without slots, or with the groups forced, they keep
    4."""
    rng = np.random.default_rng(6)
    m, n = 4096, 2048
    A = sp.random(m, n, density=0.0625, random_state=rng).tocoo()
    M = csr_from_coo(A.row, A.col, A.data, m, n, torch.float32, "cpu")
    assert build_tiles(M, strip_width=160).n_groups == 4
    T = build_tiles(M, strip_width=160, slots=SLOTS)
    assert (T.n_strips, T.n_groups, T.group_strips) == (13, 3, 5)
    assert T.live_chunks <= SLOTS[3]
    assert build_tiles(M, strip_width=160, strip_groups=4,
                       slots=SLOTS).n_groups == 4
    x = torch.as_tensor(rng.normal(size=n)).float()
    assert torch.equal(tiled_spmv_reference(T, x), spmv_reference(M, x))


def test_tiles_take_the_devices_slots_by_default(monkeypatch):
    """build_tiles with no slots asks the tiles' device for its resident
    clusters (ops/spmv.py::cluster_slots), so that every caller on the
    card gets tiles cut to one wave: the table the device answers lays the
    tiles out as that table given; the CPU answers None, the uncapped
    layout; a slots of another kind raises."""
    from hprlp_tpu_torch.ops import spmv

    rng = np.random.default_rng(6)
    m, n = 4096, 2048
    A = sp.random(m, n, density=0.0625, random_state=rng).tocoo()
    M = csr_from_coo(A.row, A.col, A.data, m, n, torch.float32, "cpu")
    uncapped = build_tiles(M, strip_width=160, slots=None)
    assert build_tiles(M, strip_width=160).n_groups == uncapped.n_groups == 4
    asked = []
    monkeypatch.setattr(spmv, "cluster_slots",
                        lambda dev: asked.append(dev) or SLOTS)
    T = build_tiles(M, strip_width=160)
    given = build_tiles(M, strip_width=160, slots=SLOTS)
    assert asked == [M.indptr.device]
    assert (T.n_groups, T.live_chunks) == (given.n_groups, given.live_chunks)
    assert T.n_groups == 3
    for f in ("vals", "keys", "runs", "row_start"):
        assert torch.equal(getattr(T, f), getattr(given, f)), f
    with pytest.raises(ValueError, match="slots"):
        build_tiles(M, strip_width=160, slots="card")
