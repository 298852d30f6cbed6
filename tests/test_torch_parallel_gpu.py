"""The mesh route on the card: the tiled kernel on column slices against
the whole matrix, mesh_shape=1 in a one-rank NCCL group, its
all-reduces captured in the solve's CUDA graph, bitwise the lane solve,
and two ranks' share ingest on the card bitwise the one-card ingest.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_parallel_gpu.py
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import hprlp_tpu_torch as ht
from hprlp_tpu_torch.ops.device_problem import host_csr, upload_problem
from hprlp_tpu_torch.ops.sparse import all_reduce_sum
from hprlp_tpu_torch.ops.spmv import tiled_spmv
from hprlp_tpu_torch.ops.tiles import build_tiles
from hprlp_tpu_torch.parallel import distributed
from hprlp_tpu_torch.parallel.sharded import column_slices, slice_columns
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
    distributed.initialize(f"tcp://127.0.0.1:{distributed._free_port()}",
                           1, 0, "cuda")
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


@pytest.mark.parametrize("precision,stop_tol", [("f32", 1e-4),
                                                ("f64", 1e-6)])
def test_mesh_of_one_nccl_rank_is_the_lane_solve(precision, stop_tol,
                                                 nccl_group):
    """mesh_shape=1: the slice, the all-reduces (NCCL) captured in the
    solve's CUDA graph; every field but the times bitwise the lane
    solve's."""
    problem = random_lp(4096, 8192, 20, seed=12)
    kw = {"stop_tol": stop_tol, "precision": precision, "verbose": False,
          "use_presolve": False, "max_iter": 100_000}
    before = all_reduce_sum.launches
    got = ht.solve_problem(problem, ht.Parameters(mesh_shape=1, **kw))
    assert all_reduce_sum.launches > before
    want = ht.solve_problem(problem, ht.Parameters(spmv_backend="lane",
                                                   **kw))
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
