"""The port's mesh solves with no JAX reference: the column slices of
parallel/sharded.py, the sharded SpMV's partial products, a one-rank gloo
group in this process, the launcher and its errors, and the CLI's --mesh.

This module imports neither JAX nor the JAX package: the ranks that
tests/test_torch_parallel.py launches import it for `run_cases`, and a
rank fails if JAX was imported.  Its own tests run on the CPU in f64
unless they say otherwise; each states its tolerance.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

import hprlp_tpu_torch as ht
from hprlp_tpu_torch import cli
from hprlp_tpu_torch.ops.device_problem import host_csr, upload_problem
from hprlp_tpu_torch.ops.sparse import all_reduce_sum, spmv
from hprlp_tpu_torch.ops.spmv import spmv_reference
from hprlp_tpu_torch.ops.tiles import build_tiles, tiled_spmv_reference
from hprlp_tpu_torch.parallel import distributed
from hprlp_tpu_torch.parallel.sharded import (SLICE_ALIGN, column_slices,
                                              shard_matrix, slice_columns)
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.solver import loop

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "data", "model.mps")
# The lowered giant threshold of the "giant" case (tests/test_parallel.py's
# TestGiantMesh lowers JAX's to 100).
GIANT = 100


# --- what the launched ranks run ------------------------------------------

def run_cases(cases):
    """Run each (name, kind, args, kwargs) of `cases` in this rank's group
    on the CPU; returns {name: result}.  kind: "facts" (rank_facts),
    "solve" (solve_problem),
    "giant" (solve_problem with loop.GIANT_LANE_FIRST_NNZ lowered to GIANT
    for the call), "batched" (solve_batched), "model" (Model.solve),
    "giant_model" (overlapped: counted_model_solve with GIANT),
    "presolve_once" (presolve_once), "own_model" (own_model_solve),
    "share" (share_against_one_card),
    "share_solve" (share_solve_against_one_card)."""
    out = {}
    for name, kind, args, kwargs in cases:
        if kind == "facts":
            out[name] = rank_facts()
        elif kind == "batched":
            out[name] = ht.solve_batched(*args, **kwargs, device="cpu")
        elif kind == "model":
            problem, params = args
            out[name] = ht.Model(problem).solve(params, device="cpu")
        elif kind == "giant_model":
            out[name] = counted_model_solve(*args, giant=GIANT)
        elif kind == "presolve_once":
            out[name] = presolve_once(*args)
        elif kind == "own_model":
            out[name] = own_model_solve(*args)
        elif kind == "share":
            out[name] = share_against_one_card(*args)
        elif kind == "share_solve":
            out[name] = share_solve_against_one_card(*args)
        else:
            saved = loop.GIANT_LANE_FIRST_NNZ
            if kind == "giant":
                loop.GIANT_LANE_FIRST_NNZ = GIANT
            try:
                out[name] = ht.solve_problem(*args, **kwargs, device="cpu")
            finally:
                loop.GIANT_LANE_FIRST_NNZ = saved
    return out


def counted_model_solve(problem, params, giant=None):
    """(Model.solve's Results on the CPU, this rank's presolve calls, its
    ingests, solve_with_presolve.record), loop.GIANT_LANE_FIRST_NNZ
    lowered to `giant` for the call when given."""
    import hprlp_tpu_torch.presolve as tps

    calls = {"presolve": 0, "ingest": 0}
    real_pre, real_ingest = tps.presolve_problem, loop.build_ingest
    saved = loop.GIANT_LANE_FIRST_NNZ

    def presolve(*a, **k):
        calls["presolve"] += 1
        return real_pre(*a, **k)

    def ingest(*a, **k):
        calls["ingest"] += 1
        return real_ingest(*a, **k)

    tps.presolve_problem, loop.build_ingest = presolve, ingest
    if giant is not None:
        loop.GIANT_LANE_FIRST_NNZ = giant
    try:
        res = ht.Model(problem).solve(params, device="cpu")
    finally:
        tps.presolve_problem, loop.build_ingest = real_pre, real_ingest
        loop.GIANT_LANE_FIRST_NNZ = saved
    return res, calls["presolve"], calls["ingest"], \
        ht.model.solve_with_presolve.record


def presolve_once(problem, params):
    """counted_model_solve, with rank 1's presolve made to report a
    failure, so that a rank that presolved for itself would solve the
    original LP while rank 0 solves the reduced one."""
    import hprlp_tpu_torch.presolve as tps

    real = tps.presolve_problem

    def differs(*a, **k):
        if distributed.rank() == 1:
            return "UNAVAILABLE", None, None
        return real(*a, **k)

    tps.presolve_problem = differs
    try:
        return counted_model_solve(problem, params)
    finally:
        tps.presolve_problem = real


def own_model_problem(rank: int) -> LpProblem:
    """The LP that rank `rank` solves on its own (own_model_solve)."""
    return random_problem(60 + rank, m=30, n=45, density=0.3)


def own_model_solve(params):
    """Model.solve without mesh_shape inside the group: this rank's own
    LP (own_model_problem), presolved and solved by this rank alone, its
    log kept.  Returns (Results, solve_with_presolve.record, stdout)."""
    import contextlib
    import io

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = ht.Model(own_model_problem(distributed.rank())).solve(
            params, device="cpu")
    return res, ht.model.solve_with_presolve.record, printed.getvalue()


def one_card_then_shard(problem, params, rank, world, device="cpu"):
    """The reference of the share ingest: the one-card ingest (host_csr,
    upload_problem, scale_problem) on `device`, then shard_problem, as
    build_ingest's (lp, maps, scal, seconds)."""
    from hprlp_tpu_torch.parallel.sharded import shard_problem
    from hprlp_tpu_torch.solver.scaling import scale_problem

    device = torch.device(device)
    A, AT = host_csr(problem)
    lp, maps = upload_problem(problem, A, AT, dtype=loop.resolve_dtype(
        params, device), device=device)
    lp, scal = scale_problem(lp)
    lp = shard_problem(lp, rank, world)
    return lp, maps, scal, {"wall": 0.0, "scaling": 0.0}


def share_against_one_card(problem, precision, device="cpu"):
    """This rank's share ingest (loop.build_share_ingest) on `device`
    (its gloo group's all-reduces run on the card's tensors too) against
    one_card_then_shard on it: {what: bitwise equal?} for the scaling's
    factors and scalars, the scaled vectors, each matrix's slice and
    tiles; the upload of every host array, by its size; the ingest's
    record; the sizes (m_pad, n_pad, nnz) and the entries of A[R, :] and
    A[:, C]."""
    world, rank = distributed.world_size(), distributed.rank()
    params = quiet(mesh_shape=world, precision=precision)
    uploads = []
    as_tensor = torch.as_tensor

    def recorded(data, *a, **k):
        if isinstance(data, np.ndarray):
            uploads.append(int(data.size))
        return as_tensor(data, *a, **k)

    torch.as_tensor = recorded
    try:
        lp, _, scal, _ = loop.build_share_ingest(
            problem, params, torch.device(device), rank, world)
    finally:
        torch.as_tensor = as_tensor
    rec = loop.build_share_ingest.record
    ref, _, rscal, _ = one_card_then_shard(problem, params, rank, world,
                                           device)
    same = {k: torch.equal(getattr(scal, k), getattr(rscal, k)) for k in (
        "row_norm", "col_norm", "b_scale", "c_scale", "norm_b", "norm_c",
        "norm_b_org", "norm_c_org")}
    same.update({k: torch.equal(getattr(lp, k), getattr(ref, k))
                 for k in ("AL", "AU", "c", "l", "u")})
    for name in ("A", "AT"):
        a, b = getattr(lp, name), getattr(ref, name)
        same[name + ".shard"] = (a.shard.c0, a.shard.c1, a.nrows,
                                 a.ncols) == (b.shard.c0, b.shard.c1,
                                              b.nrows, b.ncols)
        same[name + ".csr_released"] = a.vals is None and a.indptr is None
        for f in ("vals", "keys", "runs", "row_start"):
            same[f"{name}.tiles.{f}"] = torch.equal(
                getattr(a.tiles, f), getattr(b.tiles, f))
    (r0, r1), (c0, c1) = rec["rows"], rec["cols"]
    A = problem.A.tocsr()
    return {"same": same, "uploads": uploads, "record": rec,
            "sizes": (lp.A.nrows, lp.A.ncols, problem.nnz),
            "forms": (int(A[r0:r1].nnz), int(A[:, c0:c1].nnz))}


def share_solve_against_one_card(problem, params):
    """(the mesh solve through the share ingest, the mesh solve on
    one_card_then_shard's ingest), both on the CPU."""
    world, rank = distributed.world_size(), distributed.rank()
    got = ht.solve_problem(problem, params, device="cpu")
    want = ht.solve_problem(problem, params, device="cpu",
                            _ingest=one_card_then_shard(problem, params,
                                                        rank, world))
    return got, want


def fail_on_rank(bad: int) -> int:
    """Rank `bad` raises; the others wait in a collective for it."""
    if distributed.rank() == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    dist.barrier()
    return distributed.rank()


def rank_facts() -> dict:
    """What a rank sees of its group and its interpreter."""
    return {"rank": distributed.rank(), "world": distributed.world_size(),
            "multihost": distributed.is_multihost(),
            "devices": distributed.global_device_count(),
            "backend": dist.get_backend(), "jax": "jax" in sys.modules,
            "hprlp_tpu": "hprlp_tpu" in sys.modules}


# --- helpers ----------------------------------------------------------------

def random_problem(seed, m=40, n=60, density=0.3) -> LpProblem:
    """tests/conftest.py::random_lp's LP as the port's LpProblem."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x_feas = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x_feas
    AL = Ax - rng.uniform(0.1, 2.0, m)
    AU = Ax + rng.uniform(0.1, 2.0, m)
    kind = rng.integers(0, 4, m)
    AL = np.where(kind == 1, -np.inf, AL)
    AU = np.where(kind == 2, np.inf, AU)
    eq = kind == 3
    AL = np.where(eq, Ax, AL)
    AU = np.where(eq, Ax, AU)
    l = x_feas - rng.uniform(0.1, 3.0, n)
    u = x_feas + rng.uniform(0.1, 3.0, n)
    kindv = rng.integers(0, 3, n)
    l = np.where(kindv == 1, -np.inf, l)
    u = np.where(kindv == 2, np.inf, u)
    return LpProblem.from_arrays(A, AL, AU, l, u, rng.normal(size=n))


def quiet(**kw):
    return ht.Parameters(verbose=False, use_presolve=False, **kw)


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process, destroyed after the test."""
    distributed.initialize(f"tcp://127.0.0.1:{distributed._free_port()}",
                           1, 0, "cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def same_results(a, b) -> None:
    """Every field of two Results (or BatchedResults) bitwise equal."""
    da, db = a.to_dict(), b.to_dict()
    assert da.keys() == db.keys()
    for k in da:
        if isinstance(da[k], np.ndarray) or isinstance(db[k], np.ndarray):
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
        else:
            assert da[k] == db[k], k


# --- column slices ------------------------------------------------------------

def _check_slices(col_nnz, world):
    col_nnz = np.asarray(col_nnz, np.int64)
    ncols = len(col_nnz)
    got = column_slices(col_nnz, world)
    assert len(got) == world
    assert got[0][0] == 0 and got[-1][1] == ncols
    for (a0, a1), (b0, _) in zip(got, got[1:]):
        assert a1 == b0
    for c0, c1 in got:
        assert c0 <= c1
        for c in (c0, c1):
            assert c % SLICE_ALIGN == 0 or c == ncols
    # Balanced to within one 32-column block's nnz.
    pad = np.zeros(-(-ncols // SLICE_ALIGN) * SLICE_ALIGN, np.int64)
    pad[:ncols] = col_nnz
    block = int(pad.reshape(-1, SLICE_ALIGN).sum(axis=1).max(initial=0))
    total = int(col_nnz.sum())
    for c0, c1 in got:
        assert abs(int(col_nnz[c0:c1].sum()) - total / world) <= block
    return got


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 50), min_size=1, max_size=400),
       st.integers(1, 6))
def test_column_slices_cover_align_and_balance(col_nnz, world):
    _check_slices(col_nnz, world)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_column_slices_of_skewed_and_empty_columns(world):
    """One dense block among empty columns, and all columns empty: slices
    may be empty and still cover [0, ncols)."""
    skew = np.zeros(200, np.int64)
    skew[64:96] = 9
    got = _check_slices(skew, world)
    assert sum(c1 - c0 for c0, c1 in got) == 200
    _check_slices(np.zeros(70, np.int64), world)


# --- the sharded SpMV's partial products ------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_partial_products_sum_to_the_whole(world, dtype):
    """Per slice, in this process with no group: the tiles of M[:, c0:c1]
    (plain version) on x[c0:c1], summed over the slices, equal M @ x by
    spmv on the whole matrix, for A and A^T of an LP whose slices include
    an empty one at world 4 (rtol 1e-12 in f64, 1e-5 in f32)."""
    problem = random_problem(5, m=70, n=90, density=0.15)
    A, AT = host_csr(problem)
    lp, _ = upload_problem(problem, A, AT, dtype=dtype, device="cpu")
    rng = np.random.default_rng(world)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    for M in (lp.A, lp.AT):
        x = torch.as_tensor(rng.normal(size=M.ncols)).to(dtype)
        whole = spmv(M.with_tiles(build_tiles(M)), x)
        np.testing.assert_allclose(whole, spmv_reference(M, x), rtol=rtol,
                                   atol=rtol)
        col = torch.bincount(M.indices.long(), minlength=M.ncols)
        total = torch.zeros_like(whole)
        for c0, c1 in column_slices(col.numpy(), world):
            S = slice_columns(M, c0, c1)
            assert S.ncols == c1 - c0 and S.nrows == M.nrows
            assert S.nnz == int(col[c0:c1].sum())
            total += tiled_spmv_reference(build_tiles(S), x[c0:c1])
        np.testing.assert_allclose(total, whole, rtol=rtol, atol=rtol)


def test_slice_columns_is_the_scipy_slice():
    """slice_columns(M, c0, c1) is scipy's M[:, c0:c1], entry for entry."""
    problem = random_problem(6, m=50, n=100, density=0.2)
    A, AT = host_csr(problem)
    lp, _ = upload_problem(problem, A, AT, dtype=torch.float64,
                           device="cpu")
    M = lp.A
    whole = sp.csr_matrix((M.vals.numpy(), M.indices.numpy(),
                           M.indptr.numpy()), shape=(M.nrows, M.ncols))
    for c0, c1 in ((0, 32), (32, 96), (96, 128), (64, 64)):
        S = slice_columns(M, c0, c1)
        want = whole[:, c0:c1].tocsr()
        want.sort_indices()
        np.testing.assert_array_equal(S.indptr.numpy(), want.indptr)
        np.testing.assert_array_equal(S.indices.numpy(), want.indices)
        np.testing.assert_array_equal(S.vals.numpy(), want.data)
    with pytest.raises(ValueError):
        slice_columns(lp.A, 64, 32)


def test_a_shard_keeps_its_tiles_alone(one_rank_group):
    """shard_matrix keeps the slice's tiles (no CSR order) and a Shard, no
    CSR arrays; spmv on it (one rank: the slice is the whole) is bitwise
    the whole matrix's tiled product, and counts one all-reduce."""
    problem = random_problem(7, m=64, n=96, density=0.2)
    A, AT = host_csr(problem)
    lp, _ = upload_problem(problem, A, AT, dtype=torch.float64,
                           device="cpu")
    S = shard_matrix(lp.A, 0, 1)
    assert S.indptr is None and S.indices is None and S.vals is None
    assert S.tiles.perm is None and S.nnz == lp.A.nnz
    assert (S.shard.c0, S.shard.c1) == (0, lp.A.ncols)
    assert (S.nrows, S.ncols, S.dtype) == (lp.A.nrows, lp.A.ncols,
                                           torch.float64)
    x = torch.randn(lp.A.ncols, dtype=torch.float64)
    before = all_reduce_sum.launches
    got = spmv(S, x)
    assert all_reduce_sum.launches == before + 1
    want = tiled_spmv_reference(build_tiles(lp.A), x)
    assert torch.equal(got, want)


# --- a one-rank group in this process ---------------------------------------

@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_mesh_of_one_rank_is_the_lane_solve(precision, one_rank_group):
    """mesh_shape=1 in a one-rank gloo group runs the whole sharded route
    (the slice, the all-reduce): every field of its Results, times
    aside, bitwise those of spmv_backend="lane" with no mesh."""
    problem = random_problem(21, m=60, n=80, density=0.2)
    kw = {"stop_tol": 1e-6 if precision == "f64" else 1e-4,
          "precision": precision}
    before = all_reduce_sum.launches
    got = ht.solve_problem(problem, quiet(mesh_shape=1, **kw),
                           device="cpu")
    assert all_reduce_sum.launches > before
    want = ht.solve_problem(problem, quiet(spmv_backend="lane", **kw),
                            device="cpu")
    for name in loop.TIME_FIELDS:
        setattr(got, name, 0.0)
        setattr(want, name, 0.0)
    same_results(got, want)
    assert got.status == "OPTIMAL" and got.spmv_backend == "tiled"


def test_mixed_mesh_of_one_rank_is_the_one_card_mixed(one_rank_group):
    """precision="mixed" (f32 stages, the f64 tail) with mesh_shape=1 in a
    one-rank gloo group: every stage and the tail a mesh solve on its own
    share ingest; every field of the Results, times aside, bitwise the
    one-card "mixed" solve's (tests/conftest.py's random_lp(5, 30, 40,
    0.3), ~42,000 iterations)."""
    problem = random_problem(5, m=30, n=40, density=0.3)
    kw = {"stop_tol": 1e-8, "precision": "mixed"}
    before = all_reduce_sum.launches
    got = ht.solve_problem(problem, quiet(mesh_shape=1, **kw), device="cpu")
    assert all_reduce_sum.launches > before
    want = ht.solve_problem(problem, quiet(**kw), device="cpu")
    for name in loop.TIME_FIELDS:
        setattr(got, name, 0.0)
        setattr(want, name, 0.0)
    same_results(got, want)
    assert got.status == "OPTIMAL"
    assert problem.kkt_error(got.x, got.y, got.z)["kkt"] < 1e-8


@pytest.mark.parametrize("mesh", [None, 1], ids=["one_card", "mesh1"])
def test_giant_ingest_preheats_for_its_share(mesh, monkeypatch, request):
    """In the giant regime build_ingest preheats the host allocator with
    min(nnz * 120, 24 GiB), as the JAX package's giant ingest does; under
    a mesh with the share's entries (each in two forms) * 120 / 2, which
    at one rank is the same; outside the giant regime it does not."""
    if mesh:
        request.getfixturevalue("one_rank_group")
    problem = random_problem(8)
    asked = []
    monkeypatch.setattr(loop, "preheat", asked.append)
    params = quiet(mesh_shape=mesh)
    loop.build_ingest(problem, params, "cpu")
    assert asked == []
    monkeypatch.setattr(loop, "GIANT_LANE_FIRST_NNZ", 1)
    loop.build_ingest(problem, params, "cpu")
    assert asked == [problem.nnz * loop.PREHEAT_B_PER_NNZ]
    assert loop.PREHEAT_B_PER_NNZ == 120 and loop.PREHEAT_MAX == 24 << 30


def test_batched_mesh_of_one_rank_is_the_batched_solve(one_rank_group):
    """solve_batched with mesh_shape=1 in a one-rank group: every member
    bitwise the single-device batched solve's."""
    args = batched_args(4)
    got = ht.solve_batched(*args, params=quiet(mesh_shape=1), device="cpu")
    want = ht.solve_batched(*args, params=quiet(), device="cpu")
    for name in ("time", "setup_time", "solve_time", "power_time"):
        setattr(got, name, 0.0)
        setattr(want, name, 0.0)
    same_results(got, want)


def test_mesh_shape_must_be_the_world_size(one_rank_group):
    problem = random_problem(3)
    with pytest.raises(ValueError, match="must be equal"):
        ht.solve_problem(problem, quiet(mesh_shape=2), device="cpu")
    with pytest.raises(ValueError, match="must be equal"):
        ht.solve_batched(*batched_args(4), params=quiet(mesh_shape=2),
                         device="cpu")


def test_a_gloo_group_refuses_a_card(one_rank_group, monkeypatch):
    """Nothing runs a card's mesh over gloo: a gloo group with a CUDA
    device raises (the device check stood in for)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs nccl"):
        loop.mesh_rank_device(quiet(mesh_shape=1), None)


# --- errors before any launch -------------------------------------------------

def batched_args(B, seed=9):
    """tests/test_parallel.py:66's batched LP with B members."""
    rng = np.random.default_rng(seed)
    m, n = 12, 18
    A = sp.random(m, n, density=0.4, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x0 = rng.uniform(-1, 1, size=(n, B))
    Ax = A @ x0
    return (A, rng.normal(size=(n, B)), Ax - 1.0, Ax + 1.0, x0 - 2.0,
            x0 + 2.0)


@pytest.mark.parametrize("kw", [{"spmv_backend": "gather"},
                                {"spmv_backend": "dense"}],
                         ids=["gather", "dense"])
def test_what_a_mesh_does_not_run_raises(kw):
    problem = random_problem(3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ht.solve_problem(problem, quiet(mesh_shape=2, **kw), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ht.Model(problem).solve(ht.Parameters(verbose=False, mesh_shape=2,
                                              **kw), device="cpu")


def test_batch_not_divisible_by_the_mesh_raises():
    with pytest.raises(ValueError, match="not divisible"):
        ht.solve_batched(*batched_args(3), params=quiet(mesh_shape=2),
                         device="cpu")


@pytest.mark.parametrize("solve", ["single", "batched"])
def test_more_ranks_than_cards_raises(solve, monkeypatch):
    """NCCL runs one rank per card: mesh_shape above the card count raises
    before any rank starts (the card count stood in for)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank per card"):
        if solve == "single":
            ht.solve_problem(random_problem(3), quiet(mesh_shape=2))
        else:
            ht.solve_batched(*batched_args(4), params=quiet(mesh_shape=2))


def test_a_server_request_with_a_mesh_answers_the_mesh_solve(capfd):
    """A `solve` request with mesh_shape=2 to the server on --device cpu
    launches 2 gloo ranks, as Model.solve does without a group: its
    answer is the in-process mesh Model.solve's (status, iterations,
    objective, x bitwise), and stderr names the ranks' start seconds."""
    import base64

    from hprlp_tpu_torch import server

    problem = random_problem(21, m=60, n=80, density=0.2)
    A = problem.A.tocsr()

    def enc(a, dtype):
        return base64.b64encode(np.ascontiguousarray(
            a, dtype=dtype).tobytes()).decode("ascii")

    req = {"op": "solve", "m": problem.m, "n": problem.n,
           "Ap": enc(A.indptr, "<i8"), "Ai": enc(A.indices, "<i8"),
           "Ax": enc(A.data, "<f8"), "AL": enc(problem.AL, "<f8"),
           "AU": enc(problem.AU, "<f8"), "l": enc(problem.l, "<f8"),
           "u": enc(problem.u, "<f8"), "c": enc(problem.c, "<f8"),
           "params": {"mesh_shape": 2, "stop_tol": 1e-6}}
    reply = server.handle(req, device="cpu")
    assert reply["ok"], reply
    err = capfd.readouterr().err
    assert "mesh of 2 ranks: groups up in" in err
    assert err.count("group up in") == 2
    want = ht.Model(problem).solve(ht.Parameters(
        verbose=False, stop_tol=1e-6, mesh_shape=2), device="cpu")
    got = reply["result"]
    assert got["status"] == want.status == "OPTIMAL"
    assert got["iter"] == want.iter and got["primal_obj"] == want.primal_obj
    np.testing.assert_array_equal(
        np.frombuffer(base64.b64decode(got["x"]), "<f8"), want.x)


# --- launches -------------------------------------------------------------------

def test_a_failed_rank_raises_with_its_stderr():
    """Rank 1 raises while rank 0 waits for it in a collective: the launch
    kills rank 0 and raises RuntimeError carrying rank 1's error."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        distributed.launch(fail_on_rank, (1,), world=2, device_type="cpu",
                           timeout=120)
    assert distributed.launch.record is None


TORCHRUN_RANK = """
import sys
import hprlp_tpu_torch as ht
from hprlp_tpu_torch.io.mps import read_mps
from hprlp_tpu_torch.parallel import distributed
distributed.initialize(device_type="cpu")
distributed.initialize(device_type="cpu")  # idempotent
res = ht.solve_problem(read_mps(sys.argv[1]), ht.Parameters(
    verbose=True, use_presolve=False,
    mesh_shape=distributed.world_size()), device="cpu")
print(distributed.rank(), distributed.world_size(), res.status,
      repr(float(res.primal_obj)), "jax" in sys.modules)
"""


def test_ranks_started_as_torchrun_starts_them():
    """Two processes with torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) call initialize() with no
    arguments and solve with mesh_shape=world_size() inside the group:
    the same status and objective bits on both (-26.4 to 1e-3), and only
    rank 0 prints the solve's log."""
    port = distributed._free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r),
                   LOCAL_RANK=str(r), GLOO_SOCKET_IFNAME="lo",
                   PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", TORCHRUN_RANK, MODEL], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    last = [out.strip().splitlines()[-1].split() for out, _ in outs]
    assert [ln[:3] for ln in last] == [["0", "2", "OPTIMAL"],
                                       ["1", "2", "OPTIMAL"]]
    assert last[0][3] == last[1][3] and last[0][4] == last[1][4] == "False"
    assert float(last[0][3]) == pytest.approx(-26.4, rel=1e-3)
    assert "Solution Summary" in outs[0][0]
    assert "Solution Summary" not in outs[1][0]


def test_cli_mesh_on_cpu_ranks(capsys):
    """cli.main --mesh 2 --device cpu: two gloo ranks, rc 0, -26.4; each
    rank in a fresh interpreter without JAX, its group up before its
    solve (launch.record's start seconds)."""
    assert cli.main(["-i", MODEL, "--mesh", "2", "--device", "cpu",
                     "--quiet"]) == 0
    out = capsys.readouterr()
    line = [ln for ln in out.out.splitlines() if ln.startswith("status=")]
    assert len(line) == 1 and "status=OPTIMAL" in line[0]
    obj = float(line[0].split("obj=")[1].split()[0])
    assert obj == pytest.approx(-26.4, rel=1e-3)
    rec = distributed.launch.record
    assert rec["world"] == 2 and len(rec["start_s"]) == 2
    assert all(0 < s < rec["wall_s"] for s in rec["start_s"])
    assert out.err.count("group up in") == 2


def test_cli_mesh_flag_sets_mesh_shape(monkeypatch, capsys):
    """--mesh N is Parameters.mesh_shape; with it --device takes 0 or cpu
    (rank r runs on card r), else exit 1."""
    args = cli.build_parser().parse_args(["-i", MODEL, "--mesh", "3"])
    assert cli.params_from_args(args).mesh_shape == 3
    assert cli.params_from_args(cli.build_parser().parse_args(
        ["-i", MODEL])).mesh_shape is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cli.main(["-i", MODEL, "--mesh", "2", "--device", "1"]) == 1
    assert "--device takes 0 or cpu" in capsys.readouterr().err
