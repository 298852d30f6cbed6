"""The port's SpMM (hprlp_tpu_torch/ops/spmm.py, ops/sparse.py) on the CPU:
the plain version against the JAX package's spmm (gather backend, ELL
buckets) and scipy, the dense dispatch, the kernel's launch plan, and the
wrapper's refusals.  The kernel itself is tested on the card by
tests/test_torch_spmm_gpu.py.

Tolerances: 1e-5 * max|Y| in f32 and 1e-13 * max|Y| in f64 -- the
summation order differs between CSR rows, ELL buckets and scipy.
"""

import contextlib
import types

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
from hprlp_tpu_torch.ops.spmm import (csr_spmm, spmm_grid, spmm_plan,
                                      spmm_reference)

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


# ---------------------------------------------------------------------------
# The solver design's launch plan and the fused halves' wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("ncols", [16, 65536, 131072, 524288, 2**24])
@pytest.mark.parametrize("B", [1, 3, 8, 33, 64, 100, 256, 1000])
def test_plan_caps_each_slice_under_the_l2_budget(B, ncols, itemsize):
    """A slice's window of X (ncols x G x V x itemsize) stays within
    L2_BUDGET unless one group of one lane is already wider; G is the
    widest group that does, or covers B, or is a warp; the slices cover
    B; the loads are as wide as B and the alignment allow."""
    for address in (0, itemsize, 16, 512):
        G, V, n_slices = spmm_plan(B, itemsize, address, ncols)
        assert (G, V, n_slices)[1] == spmm_plan(B, itemsize, address)[1]
        assert G in (1, 2, 4, 8, 16, 32)
        window = ncols * G * V * itemsize
        assert window <= spmm_mod.L2_BUDGET or G == 1
        assert G == 32 or G * V >= B or 2 * window > spmm_mod.L2_BUDGET
        assert n_slices * G * V >= B > (n_slices - 1) * G * V


def test_plan_at_sparse_large():
    """sparse_large's A (131,072 columns): 64 f32 or 32 f64 columns a
    slice, so B = 256 runs in 4 or 8 slices; its A^T (65,536 columns)
    takes 128 f32 or 64 f64 columns."""
    assert spmm_plan(64, 4, 0, 131072) == (16, 4, 1)
    assert spmm_plan(256, 4, 0, 131072) == (16, 4, 4)
    assert spmm_plan(64, 8, 0, 131072) == (16, 2, 2)
    assert spmm_plan(256, 8, 0, 131072) == (16, 2, 8)
    assert spmm_plan(256, 4, 0, 65536) == (32, 4, 2)
    assert spmm_plan(256, 8, 0, 65536) == (32, 2, 4)
    assert spmm_plan(8, 4, 0, 131072) == (2, 4, 1)
    assert spmm_plan(1, 8, 0, 131072) == (1, 1, 1)


@pytest.mark.parametrize("nrows", [1, 15, 16, 17, 255, 256, 257, 65536])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_grid_runs_the_slices_one_after_another(nrows, G):
    """The grid is (row blocks, slices): blocks start rows fastest, so all
    of one slice's rows are in flight before the next slice's; a block of
    BLOCK threads owns BLOCK // G consecutive rows, and the blocks cover
    every row once."""
    for n_slices in (1, 3):
        gx, gy = spmm_mod.spmm_grid(nrows, G, n_slices)
        assert gy == n_slices
        per_block = spmm_mod.BLOCK // G
        assert gx * per_block >= nrows > (gx - 1) * per_block


def test_launch_plan_is_cached_per_shape_dtype_and_alignment():
    """(G, V, grid_x, n_slices) per shape, dtype and alignment."""
    plan = spmm_mod._launch_plan
    a = plan(65536, 131072, 64, 4, 0)
    assert a == (16, 4, 65536 // (spmm_mod.BLOCK // 16), 1)
    assert plan(65536, 131072, 64, 4, 0) is a
    assert plan(65536, 131072, 64, 4, 4)[1] == 1


@pytest.mark.parametrize("wrapper, library, source", [
    ("csr_spmm", "_library", "SOURCE"),
    ("csr_spmm_rowwise", "_rowwise_library", "ROWWISE_SOURCE")])
def test_each_design_builds_only_its_own_source(monkeypatch, wrapper,
                                                library, source):
    """The solver's kernels and the previous design are separate
    libraries: a solve builds only csrc/spmm.cu, and the previous design
    only csrc/spmm_rowwise.cu."""
    built = []

    def no_build(src=None, ptxas_log=None):
        built.append(src)
        raise RuntimeError("nvcc failed (1): stand-in")

    monkeypatch.setattr(spmm_mod, "build", no_build)
    monkeypatch.setattr(spmm_mod, "check_spmm_args", lambda A, X: None)
    getattr(spmm_mod, library).cache_clear()
    M = csr_from_coo([0], [0], [1.0], 4, 4, torch.float32, "cpu")
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            getattr(spmm_mod, wrapper)(M, torch.ones(4, 2))
    finally:
        getattr(spmm_mod, library).cache_clear()
    assert built == [getattr(spmm_mod, source)]
    assert spmm_mod.SOURCE != spmm_mod.ROWWISE_SOURCE


def _half_inputs(n=6, m=4, B=3, dtype=torch.float32, device="cpu"):
    M = csr_from_coo([0, 1, 2, 3], [0, 1, 2, 3], [1.0] * 4, n, m, dtype,
                     device)
    rows = {k: torch.ones(n, B, dtype=dtype, device=device)
            for k in ("x", "last_x", "c", "l", "u")}
    y = torch.ones(m, B, dtype=dtype, device=device)
    return (M, y, *rows.values(), torch.ones(B, dtype=dtype, device=device),
            torch.zeros(B, dtype=torch.int32, device=device),
            torch.ones(B, dtype=torch.bool, device=device), 0)


def test_fused_wrappers_refuse_cpu_tensors_and_bad_arguments(monkeypatch):
    """No hidden fallback: the fused halves take only CUDA tensors; past
    the device check (stood in for here), a wrong shape, dtype or length
    raises."""
    args = _half_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        spmm_mod.spmm_x_half(*args)
    with pytest.raises(ValueError, match="CUDA"):
        spmm_mod.spmm_y_half(*args[:6], *args[7:])
    monkeypatch.setattr(spmm_mod, "check_csr_matrix", lambda A, X: None)
    M, y, x, last_x, c, l, u, sigma, inner, active, _ = args

    def check(**kw):
        rows = {"x": x, "last_x": last_x, "c": c, "l": l, "u": u}
        rows.update({k: v for k, v in kw.items() if k in rows})
        spmm_mod.check_half_args(M, kw.get("y", y), rows,
                                 kw.get("sigma", sigma),
                                 kw.get("inner", inner),
                                 kw.get("active", active))

    check()
    for kw, err in (({"x": x[:, :2].contiguous()}, ValueError),
                    ({"last_x": x.t()}, ValueError),
                    ({"u": u.double()}, TypeError),
                    ({"sigma": sigma[:2]}, ValueError),
                    ({"inner": inner.long()}, TypeError),
                    ({"active": active.int()}, TypeError),
                    ({"y": y[:3]}, ValueError)):
        with pytest.raises(err):
            check(**kw)


@pytest.mark.parametrize("half", ["x", "y", "y_previous"])
def test_failed_build_of_the_fused_halves_raises(monkeypatch, half):
    """A fused half whose kernel does not build raises from its wrapper,
    and its launch count stays."""
    def no_build(source=None, ptxas_log=None):
        raise RuntimeError("nvcc failed (1): stand-in")

    monkeypatch.setattr(spmm_mod, "build", no_build)
    monkeypatch.setattr(spmm_mod, "check_half_args", lambda *a: None)
    spmm_mod._library.cache_clear()
    M, y, x, last_x, c, l, u, sigma, inner, active, t = _half_inputs()
    fn = {"x": spmm_mod.spmm_x_half, "y": spmm_mod.spmm_y_half,
          "y_previous": spmm_mod.spmm_y_half_previous}[half]
    args = ((M, y, x, last_x, c, l, u, sigma, inner, active, t)
            if half == "x" else (M, x, y, y, y, y, sigma, inner, active, t))
    before = fn.launches
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fn(*args)
    finally:
        spmm_mod._library.cache_clear()
    assert fn.launches == before


# ---------------------------------------------------------------------------
# The y-half's ring kernel (csrc/spmm.cu spmm_y_ring_kernel): its plan.

RING_BATCHES = [1, 2, 3, 4, 8, 64, 256]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("ncols", [16, 131072, 524288])
@pytest.mark.parametrize("B", RING_BATCHES)
def test_ring_plan_fits_and_keeps_the_products_slices(B, ncols, itemsize):
    """For every alignment: the product's groups, loads, slices and grid
    (so the slices cover B, each slice's window of X stays within
    L2_BUDGET unless one lane is already wider, and the grid covers the
    rows once, a row a group), and a block's shared memory within the
    H100's 232,448 bytes."""
    nrows = 65536
    for address in (0, itemsize, 8, 16):
        plan = spmm_mod.ring_plan(nrows, ncols, B, itemsize, address)
        assert (plan.G, plan.V, plan.n_slices) == spmm_plan(
            B, itemsize, address, ncols)
        assert plan.n_slices * plan.G * plan.V >= B \
            > (plan.n_slices - 1) * plan.G * plan.V
        assert ncols * plan.G * plan.V * itemsize <= spmm_mod.L2_BUDGET \
            or plan.G == 1
        assert plan.smem_bytes == spmm_mod.ring_smem_bytes(
            plan.V, itemsize) <= 232_448
        rows = spmm_mod.BLOCK // plan.G
        assert plan.grid_x * rows >= nrows > (plan.grid_x - 1) * rows
        assert (plan.grid_x, plan.n_slices) == spmm_grid(nrows, plan.G,
                                                         plan.n_slices)


@pytest.mark.parametrize("itemsize, want", [
    (4, (16, 4, 1, 4096, 47104)),
    (8, (16, 2, 2, 4096, 65536))])
def test_ring_plan_at_batched_large(itemsize, want):
    """batched_large (65,536 x 131,072, B = 64): one f32 slice of 64
    columns or two f64 slices of 32, 46 or 64 KB of shared memory a
    block."""
    assert tuple(spmm_mod.ring_plan(65536, 131072, 64, itemsize, 0)) == want


def test_ring_plan_is_cached():
    plan = spmm_mod.ring_plan
    a = plan(65536, 131072, 64, 4, 0)
    assert plan(65536, 131072, 64, 4, 0) is a
    assert plan(65536, 131072, 64, 4, 4).V == 1


@pytest.mark.parametrize("itemsize, V", [(4, 1), (4, 2), (4, 4), (8, 1),
                                         (8, 2)])
def test_every_ring_instance_fits_shared_memory(itemsize, V):
    """Each instance the y-half launches takes at most the H100's 232,448
    bytes of shared memory a block (the source asserts it when it
    compiles), and its ring holds at least two slots a lane."""
    assert spmm_mod.ring_smem_bytes(V, itemsize) <= 232_448
    assert 2 * spmm_mod.RING_BATCH[itemsize] >= 2


def test_ring_constants_match_the_source():
    """ops/spmm.py mirrors csrc/spmm.cu's batch per value type, its block
    and its shared-memory formula, which the source checks against the
    H100's cap."""
    import re

    src = open(spmm_mod.SOURCE).read()
    for T, itemsize in (("float", 4), ("double", 8)):
        m = re.search(r"struct Ring<%s> \{\s*static constexpr int kBatch = "
                      r"(\d+)" % T, src)
        assert int(m.group(1)) == spmm_mod.RING_BATCH[itemsize]
    assert int(re.search(r"kRingMaxSmem = (\d+);", src).group(1)) == 232_448
    assert "static_assert(smem <= kRingMaxSmem" in src
    assert "kBlock * (2 * Ring<T>::kBatch * (V + 1) + 4 * V)" in src
    assert int(re.search(r"kBlock = (\d+);", src).group(1)) \
        == spmm_mod.BLOCK


def test_ynew_store_probe_changes_only_the_store(monkeypatch, tmp_path):
    """prof/prof_ynew_store.py times csrc/spmm.cu as it is against a copy
    whose ring kernel stores y_new plainly: the copy differs in that one
    statement, keeps the headers beside it, and both are built."""
    from hprlp_tpu_torch.prof import prof_ynew_store as probe

    built = []
    monkeypatch.setattr(probe, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(probe, "build", lambda path, ptxas_log: (
        built.append(path), ptxas_log.append("log")))
    forms = probe.build_forms()
    assert forms["evict_first"] == (spmm_mod.SOURCE, "log")
    plain = forms["plain"][0]
    assert sorted(built) == sorted([spmm_mod.SOURCE, plain])
    assert (tmp_path / "ynew_store" / "hpr_half.cuh").exists()
    src = open(spmm_mod.SOURCE).read().splitlines()
    copy = open(plain).read().splitlines()
    assert len(src) == len(copy)
    diff = [(a.strip(), b.strip()) for a, b in zip(src, copy) if a != b]
    assert diff == [(probe.EVICT, probe.PLAIN)]


def _y_inputs(dtype=torch.float32, device="cpu"):
    M, y, x, last_x, c, l, u, sigma, inner, active, t = _half_inputs(
        dtype=dtype, device=device)
    # M (6 x 4) as A: x_hat is y's (4, B) and y is x's (6, B).
    return (M, y, x, x.clone(), x.clone(), x.clone(), sigma, inner, active,
            t)


@pytest.mark.parametrize("wrapper", ["spmm_y_half", "spmm_y_half_previous"])
def test_y_half_wrappers_refuse_cpu_tensors_and_bad_arguments(monkeypatch,
                                                              wrapper):
    """Neither y-half falls back to plain PyTorch: a CPU tensor raises, and
    past the device check (stood in for here) so does a bad argument,
    before any build or launch."""
    fn = getattr(spmm_mod, wrapper)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*_y_inputs())
    monkeypatch.setattr(spmm_mod, "check_csr_matrix", lambda A, X: None)

    def no_library():
        raise AssertionError("launched past a bad argument")

    monkeypatch.setattr(spmm_mod, "_library", no_library)
    before = fn.launches
    args = _y_inputs()
    for i, bad, err in ((2, args[2][:2], ValueError),
                        (4, args[4].double(), TypeError),
                        (6, args[6][:2], ValueError),
                        (7, args[7].long(), TypeError),
                        (8, args[8].int(), TypeError)):
        bad_args = list(args)
        bad_args[i] = bad
        with pytest.raises(err):
            fn(*bad_args)
    assert fn.launches == before


class _FakeRingLib:
    """csrc/spmm.cu's library as the ring wrapper calls it, recording the
    device current at each set-up and launch."""

    def __init__(self, current, init_err=0):
        self.current, self.init_err = current, init_err
        self.inits, self.launches = [], []

    def hprlp_spmm_ring_init(self):
        self.inits.append(self.current[0])
        return self.init_err

    def hprlp_spmm_y_ring(self, *args):
        self.launches.append(self.current[0])
        return 0

    def hprlp_spmm_error_string(self, err):
        return b"invalid argument"


def _fake_devices(monkeypatch, lib):
    """Stand in torch.cuda's device switch, current device and stream with
    lib.current, so that the wrapper's device handling runs on the CPU."""
    current = lib.current

    @contextlib.contextmanager
    def device(index):
        saved, current[0] = current[0], index
        try:
            yield
        finally:
            current[0] = saved

    monkeypatch.setattr(spmm_mod, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return device


def test_a_failed_ring_setup_raises(monkeypatch):
    """The ring kernel's shared-memory set-up on a device raises when the
    library reports an error, and nothing is cached: the next call tries
    again."""
    lib = _FakeRingLib([0], init_err=1)
    _fake_devices(monkeypatch, lib)
    spmm_mod._ring_ready.cache_clear()
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError, match="ring kernel could not "
                                                   "be set up"):
                spmm_mod._ring_ready(0)
    finally:
        spmm_mod._ring_ready.cache_clear()
    assert lib.inits == [0, 0]


def test_ring_setup_is_made_once_for_each_device(monkeypatch):
    """The shared-memory attributes belong to a device's context, so the
    ring wrapper sets them up on the device it launches on, inside its
    device guard, once for each device index: a launch on device 1 from a
    process whose current device is 0 sets up device 1 first."""
    lib = _FakeRingLib([0])
    device = _fake_devices(monkeypatch, lib)
    target = [0]
    monkeypatch.setattr(spmm_mod, "_device_guard",
                        lambda dev: device(target[0]))
    M, x_hat, y, last_y, AL, AU, lam, inner, active, t = _y_inputs()
    spmm_mod._ring_ready.cache_clear()
    try:
        for index in (1, 0, 1, 0, 1):
            target[0] = index
            spmm_mod._ring_launch(M, x_hat, torch.empty_like(y), y, last_y,
                                  AL, AU, lam, inner, active, t)
    finally:
        spmm_mod._ring_ready.cache_clear()
    assert lib.inits == [1, 0]
    assert lib.launches == [1, 0, 1, 0, 1]
    assert lib.current == [0]


def test_new_counters_start_at_zero():
    """The previous y-half counts its launches apart, from 0, in the
    solver's counted wrappers and the server's report; no CPU test
    launches it."""
    from hprlp_tpu_torch import server
    from hprlp_tpu_torch.solver import graph

    assert spmm_mod.spmm_y_half_previous.launches == 0
    assert graph.COUNTED["spmm_y_half_previous"] \
        is spmm_mod.spmm_y_half_previous
    assert graph.COUNTED["spmm_y_half"] is spmm_mod.spmm_y_half
    assert server.launch_counts()["spmm_y_half_previous"] == 0
