"""The mesh route on the card: the tiled kernel on column slices against
the whole matrix, the CSR kernel and its fused halves on row slices
against the whole matrix and their plain versions, mesh_shape=1 in a
one-rank NCCL group, its all-reduces or all-gathers captured in the
solve's CUDA graph, bitwise the one-card solve on each backend, and two
ranks' share ingest on the card bitwise the one-card ingest.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_parallel_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import hprlp_tpu_torch as ht
from hprlp_tpu_torch.ops.device_problem import (canonical_csr, host_csr,
                                                upload_problem)
from hprlp_tpu_torch.ops.sparse import (CsrMatrix, all_gather_rows,
                                        all_reduce_sum)
from hprlp_tpu_torch.ops.spmv import (csr_spmv, csr_spmv_plain, row_blocks,
                                      spmv_x_half, spmv_y_half, tiled_spmv)
from hprlp_tpu_torch.ops.tiles import build_tiles
from hprlp_tpu_torch.parallel import distributed
from hprlp_tpu_torch.parallel.sharded import (column_slices, share_cuts,
                                              slice_columns)
from hprlp_tpu_torch.solver import chunk
from hprlp_tpu_torch.prof.problems import random_lp
from hprlp_tpu_torch.solver import loop

from test_torch_parallel_ranks import batched_args, same_results

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tiled kernel has no CPU mode")
    return torch.device("cuda:0")


@pytest.fixture
def nccl_group(cuda):
    """A one-rank NCCL group in this process on cuda:0."""
    distributed.initialize(world_size=1, rank=0, device_type="cuda",
                           store=distributed.host_store())
    try:
        yield cuda
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("world", [2, 3, 4])
def test_slices_sum_to_the_whole_matrix(world, dtype, cuda):
    """The tiled kernel on each column slice's tiles and x[c0:c1], summed,
    against the kernel on the whole matrix, for A and A^T (rtol 1e-5 in
    f32, 1e-12 in f64, relative to the row sums of |A| |x|)."""
    problem = random_lp(4096, 8192, 20, seed=11)
    A, AT = host_csr(problem)
    lp, _ = upload_problem(problem, A, AT, dtype=dtype, device=cuda)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    gen = torch.Generator(device=cuda).manual_seed(world)
    for M in (lp.A, lp.AT):
        x = torch.randn(M.ncols, generator=gen, device=cuda, dtype=dtype)
        whole = tiled_spmv(build_tiles(M).without_perm(), x)
        col = torch.bincount(M.indices.long(), minlength=M.ncols)
        total = torch.zeros_like(whole)
        for c0, c1 in column_slices(col.cpu().numpy(), world):
            T = build_tiles(slice_columns(M, c0, c1)).without_perm()
            total += tiled_spmv(T, x[c0:c1])
        absM = M.with_vals(M.vals.abs())
        scale = tiled_spmv(build_tiles(absM).without_perm(), x.abs())
        assert float(((total - whole).abs() / (scale + 1e-30)).max()) < tol


def row_slice(M, r0: int, r1: int) -> CsrMatrix:
    """Rows [r0, r1) of CSR matrix M as a matrix of their own, its arrays
    copied (so 16-byte aligned, as a rank's upload is), with its
    row-block plan."""
    e0, e1 = int(M.indptr[r0]), int(M.indptr[r1])
    S = CsrMatrix(indptr=(M.indptr[r0:r1 + 1] - e0).contiguous(),
                  indices=M.indices[e0:e1].clone(),
                  vals=M.vals[e0:e1].clone(), nrows=r1 - r0, ncols=M.ncols)
    return dataclasses.replace(S, blocks=row_blocks(S))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("world", [2, 3, 4])
def test_row_slices_are_the_whole_matrix(world, dtype, cuda):
    """The CSR kernel and its fused halves on each row slice of A and A^T
    (share_cuts' R and C; a row longer than the kernel's window in row 7
    of A), concatenated: bitwise the kernel on the whole matrix and its
    plain version (csr_spmv_plain; the halves' plain ops on it)."""
    problem = random_lp(4096, 8192, 20, seed=11)
    A = problem.A.tolil()
    A[7, :3000] = np.arange(1, 3001) / 3000.0
    problem.A = A.tocsr()
    Ah, ATh = host_csr(problem)
    lp, _ = upload_problem(problem, Ah, ATh, dtype=dtype, device=cuda)
    row_cuts, col_cuts, _ = share_cuts(canonical_csr(problem), lp.m, lp.n,
                                       0, world)
    gen = torch.Generator(device=cuda).manual_seed(world)

    def rand(k):
        return torch.randn(k, generator=gen, device=cuda, dtype=dtype)

    inner = torch.tensor(4, dtype=torch.int32, device=cuda)
    scal = torch.tensor(0.9, dtype=dtype, device=cuda)
    for M, cuts, half in ((lp.A, row_cuts, "y"), (lp.AT, col_cuts, "x")):
        M = dataclasses.replace(M, blocks=row_blocks(M))
        v = rand(M.ncols)
        rows = [rand(M.nrows) for _ in range(5)]
        rows[3], rows[4] = -rows[3].abs(), rows[4].abs()  # bounds
        slices = [row_slice(M, a, b) for a, b in zip(cuts, cuts[1:])]
        got = torch.cat([csr_spmv(S, v) for S in slices])
        assert torch.equal(got, csr_spmv(M, v))
        assert torch.equal(got, csr_spmv_plain(M, v))
        h = chunk.Halpern(inner, 2, dtype)
        if half == "x":
            x, last_x, c, l, u = rows
            parts = [spmv_x_half(S, v, x[a:b], last_x[a:b], c[a:b], l[a:b],
                                 u[a:b], scal, inner, 2)
                     for S, a, b in zip(slices, cuts, cuts[1:])]
            whole = spmv_x_half(M, v, x, last_x, c, l, u, scal, inner, 2)
            for k in range(2):
                assert torch.equal(torch.cat([p[k] for p in parts]),
                                   whole[k])
            lp_one = dataclasses.replace(lp, AT=M, c=c, l=l, u=u)
            plain = chunk.x_half_plain(lp_one, x, v, last_x, scal, h)
            for k in range(2):
                assert torch.equal(whole[k], plain[k])
        else:
            y, last_y, _, AL, AU = rows
            parts = [spmv_y_half(S, v, y[a:b], last_y[a:b], AL[a:b],
                                 AU[a:b], scal, inner, 2)
                     for S, a, b in zip(slices, cuts, cuts[1:])]
            whole = spmv_y_half(M, v, y, last_y, AL, AU, scal, inner, 2)
            assert torch.equal(torch.cat(parts), whole)
            lp_one = dataclasses.replace(lp, A=M, AL=AL, AU=AU)
            plain = chunk.y_half_plain(lp_one, y, v, last_y, scal, h)
            assert torch.equal(whole, plain)


@pytest.mark.parametrize("backend", ["gather", "dense", "auto"])
@pytest.mark.parametrize("precision,stop_tol", [("f32", 1e-4),
                                                ("f64", 1e-6)])
def test_mesh_of_one_nccl_rank_is_the_one_card_solve(precision, stop_tol,
                                                     backend, nccl_group):
    """mesh_shape=1 with spmv_backend "gather", "dense" or "auto" (the
    row shards, their all-gathers captured in the CUDA graph; "auto"
    probing both forms on this 164K-nnz LP): every field but the times
    bitwise the one-card solve with the backend it ran."""
    problem = random_lp(4096, 8192, 20, seed=12)
    kw = {"stop_tol": stop_tol, "precision": precision, "verbose": False,
          "use_presolve": False, "max_iter": 100_000}
    before = all_gather_rows.launches
    got = ht.solve_problem(problem, ht.Parameters(
        mesh_shape=1, spmv_backend=backend, **kw))
    ran = "lane" if got.spmv_backend == "tiled" else got.spmv_backend
    assert (all_gather_rows.launches > before) == (ran != "lane")
    if backend != "auto":
        assert ran == backend
    want = ht.solve_problem(problem, ht.Parameters(spmv_backend=ran, **kw))
    for name in loop.TIME_FIELDS:
        setattr(got, name, 0.0)
        setattr(want, name, 0.0)
    same_results(got, want)
    assert got.status == "OPTIMAL"


@pytest.mark.parametrize("precision,stop_tol", [("f32", 1e-4),
                                                ("f64", 1e-6)])
def test_mesh_of_one_nccl_rank_is_the_lane_solve(precision, stop_tol,
                                                 nccl_group):
    """mesh_shape=1 on the tiles (spmv_backend "lane": "auto" probes
    this 164K-nnz LP and may leave them): the column slice, the
    all-reduces (NCCL) captured in the solve's CUDA graph; every field but
    the times bitwise the lane solve's."""
    problem = random_lp(4096, 8192, 20, seed=12)
    kw = {"stop_tol": stop_tol, "precision": precision, "verbose": False,
          "use_presolve": False, "max_iter": 100_000,
          "spmv_backend": "lane"}
    before = all_reduce_sum.launches
    got = ht.solve_problem(problem, ht.Parameters(mesh_shape=1, **kw))
    assert all_reduce_sum.launches > before
    want = ht.solve_problem(problem, ht.Parameters(**kw))
    for name in loop.TIME_FIELDS:
        setattr(got, name, 0.0)
        setattr(want, name, 0.0)
    same_results(got, want)
    assert got.status == "OPTIMAL"


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_share_ingest_on_the_card_is_the_one_card_ingest_sliced(precision,
                                                                cuda):
    """Two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card;
    gloo all-reduces the card's tensors): each rank's share ingest on the
    card, its row sums on the SpMM kernel over its row slices, bitwise
    the one-card ingest on the card then shard_problem (factors,
    scalars, vectors, tiles); 51 exchanges."""
    import test_torch_parallel_ranks as ranks

    problem = random_lp(4096, 8192, 20, seed=12)
    case = ("share", "share", (problem, precision, "cuda:0"), {})
    per_rank = distributed.launch(ranks.run_cases, ([case],), world=2,
                                  device_type="cpu", timeout=300)
    for r, out in enumerate(per_rank):
        got = out["share"]
        assert not [k for k, ok in got["same"].items() if not ok], r
        assert got["record"]["exchanges"] == 51


def test_batched_mesh_of_one_nccl_rank_is_the_batched_solve(nccl_group):
    """solve_batched with mesh_shape=1 (members all-gathered over NCCL):
    bitwise the single-device batched solve, member for member."""
    args = batched_args(8)
    got = ht.solve_batched(*args, params=ht.Parameters(
        verbose=False, mesh_shape=1))
    want = ht.solve_batched(*args, params=ht.Parameters(verbose=False))
    for name in ("time", "setup_time", "solve_time", "power_time"):
        setattr(got, name, 0.0)
        setattr(want, name, 0.0)
    same_results(got, want)
    assert np.all(np.asarray(got.status) == "OPTIMAL")
