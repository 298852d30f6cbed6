"""The solve loops' CUDA graphs, the launch counts across replays, the
probes timed on the device and the SpMV backends on the card.

Every test here needs a CUDA device (the graphs and kernels have no CPU
mode) and skips without one.  The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -q tests/test_torch_graph_gpu.py

Graph and eager runs of the same chunks are held to bitwise equality: a
replay runs the same kernels in the same order on the same values.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu_torch.ops.device_problem import (attach_tiles,
                                                build_device_problem)
from hprlp_tpu_torch.ops.sparse import spmv_backend
from hprlp_tpu_torch.ops.spmm import csr_spmm
from hprlp_tpu_torch.ops.spmv import (csr_spmv, tiled_spmv, tiled_x_half,
                                      tiled_y_half)
from hprlp_tpu_torch.ops.tiles import build_tiles
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.solver import autotune, batched
from hprlp_tpu_torch.solver import batched_device_loop as bdl
from hprlp_tpu_torch.solver import device_loop as dl
from hprlp_tpu_torch.solver.chunk import (SolverState, init_state,
                                          initial_metrics, run_chunk)
from hprlp_tpu_torch.solver.graph import time_probe
from hprlp_tpu_torch.solver.loop import solve_problem
from hprlp_tpu_torch.solver.power_iteration import power_method
from hprlp_tpu_torch.solver.scaling import scale_problem

pytestmark = pytest.mark.gpu

CHECK = 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs and kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _arrays(m=300, n=500, density=0.04, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x
    return A, Ax - 1.0, Ax + 1.0, x - 2.0, x + 2.0, rng.normal(size=n)


def _setup(dtype, device, **kw):
    """(lp, scal, loop arguments) as solve_problem sets them up."""
    raw, _ = build_device_problem(LpProblem.from_arrays(*_arrays(**kw)),
                                  dtype=dtype, device=device)
    tiles = (build_tiles(raw.A), build_tiles(raw.AT))
    lp, scal = scale_problem(raw)
    lp = attach_tiles(lp, *tiles)
    lam = max(float(power_method(lp)) * 1.01, 1e-12)
    nb, nc = float(scal.norm_b), float(scal.norm_c)
    sigma = nb / nc if nb > 1e-8 and nc > 1e-8 else 1.0
    state = init_state(lp)

    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    args = (lp, scal, state, dl.init_restart_dev(sigma, dtype, device),
            t(sigma), t(lam), initial_metrics(lp, scal, state))
    return args, t(0.0)


def _run(args, obj_c, stop_tol, n_chunks, graph):
    return dl.run_superchunk(*args, 0, obj_c, stop_tol, n_chunks, CHECK, 1,
                             None, graph)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_replays_equal_eager_steps_bitwise(cuda, dtype):
    """Six chunks (stall recovery on): the same rows, state, restart state
    and best point, bitwise, from the graph's replays and from eager
    steps."""
    args, obj_c = _setup(dtype, cuda)
    eager = _run(args, obj_c, 0.0, 6, False)
    graph = dl.capture_superchunk(*args, obj_c, 0.0, CHECK, 1, 6)
    replayed = _run(args, obj_c, 0.0, 6, graph)
    assert eager[6] == replayed[6] == 6
    for k in dl.STACK_KEYS:
        np.testing.assert_array_equal(eager[5][k], replayed[5][k], k)
    for f in dataclasses.fields(SolverState):
        assert torch.equal(getattr(eager[0], f.name),
                           getattr(replayed[0], f.name)), f.name
    for f in dataclasses.fields(dl.RestartDev):
        assert torch.equal(getattr(eager[1], f.name),
                           getattr(replayed[1], f.name)), f.name
    for k in eager[7]:
        assert torch.equal(eager[7][k], replayed[7][k]), k


def test_the_replay_past_done_changes_nothing(cuda):
    """A stop_tol met at the second boundary: the graph stops there with
    one frozen replay queued behind it, and its state is the eager one."""
    args, obj_c = _setup(torch.float64, cuda)
    probe = _run(args, obj_c, 0.0, 2, False)
    stop_tol = float(probe[5]["kkt"][1]) * (1 + 1e-9)
    assert float(probe[5]["kkt"][0]) > stop_tol
    eager = _run(args, obj_c, stop_tol, 5, False)
    graph = dl.capture_superchunk(*args, obj_c, stop_tol, CHECK, 1, 5)
    replayed = _run(args, obj_c, stop_tol, 5, graph)
    torch.cuda.synchronize()
    assert eager[6] == replayed[6] == 2 and graph.replays == 3
    for f in dataclasses.fields(SolverState):
        assert torch.equal(getattr(eager[0], f.name),
                           getattr(replayed[0], f.name)), f.name


def test_replays_count_their_launches(cuda):
    """A chunk of n iterations runs 2n + 4 SpMVs (two per iteration, the
    first iteration's fixed-point gap, three for the residuals), the n - 2
    middle iterations' two as the fused halves: the capture counts none,
    and each replay adds them."""
    args, obj_c = _setup(torch.float32, cuda)
    graph = dl.capture_superchunk(*args, obj_c, 0.0, CHECK, 1, 4)
    per = graph.captured.per_replay
    assert (per["tiled_spmv"], per["tiled_x_half"], per["tiled_y_half"]) \
        == (8, CHECK - 2, CHECK - 2)
    tiled_spmv.launches = csr_spmv.launches = 0
    tiled_x_half.launches = tiled_y_half.launches = 0
    _run(args, obj_c, 0.0, 3, graph)
    assert tiled_spmv.launches == 3 * 8
    assert tiled_x_half.launches == tiled_y_half.launches == 3 * (CHECK - 2)
    assert csr_spmv.launches == 0


def test_time_probe_counts_apart_and_returns_the_replay(cuda):
    args, _ = _setup(torch.float32, cuda)
    lp, scal, state, _, sigma, lam, _ = args
    flag = torch.tensor(False, device=cuda)

    def fn():
        return run_chunk(lp, scal, state, sigma, lam, flag, 20)[1]["nrm_Rp"]

    counts = {}
    tiled_spmv.launches = 0
    secs, out = time_probe(fn, cuda, counts=counts)
    assert secs > 0.0 and tiled_spmv.launches == 0
    # warm-up + 4 replays, the 18 middle iterations' halves fused
    assert counts["tiled_spmv"] == 5 * 8
    assert counts["tiled_x_half"] == counts["tiled_y_half"] == 5 * 18
    assert torch.equal(out, fn())


def test_autotune_probes_on_the_card(cuda):
    """12,000 nnz, 4% dense: the tiled kernel and the CSR kernel are
    probed by device time; the probes' launches are counted apart."""
    args, _ = _setup(torch.float32, cuda, m=300, n=1000, density=0.04)
    lp, scal, state, _, sigma, _, _ = args
    probe_args = (scal, state, sigma, sigma * 0 + 4.0,
                  torch.tensor(False, device=cuda), 20)
    csr_spmv.launches = tiled_spmv.launches = 0
    got = autotune.autotune_backends(lp, probe_args)
    rec = autotune.autotune_backends.record
    assert set(rec["seconds"]) == {"tiled", "gather", "dense"}
    assert all(t > 0 for t in rec["seconds"].values())
    assert rec["choice"] == spmv_backend(got.A)
    assert rec["probe_launches"]["csr_spmv"] > 0
    assert csr_spmv.launches == tiled_spmv.launches == 0


@pytest.mark.parametrize("backend", ["gather", "dense", "auto"])
def test_solve_launches_only_its_backend(cuda, backend):
    args = _arrays(m=300, n=1000, density=0.04)
    csr_spmv.launches = tiled_spmv.launches = csr_spmm.launches = 0
    res = ht.solve(*args, ht.Parameters(
        verbose=False, spmv_backend=backend, use_presolve=False))
    assert res.status == "OPTIMAL"
    assert solve_problem.capture_time > 0.0
    used = {"tiled": tiled_spmv.launches, "gather": csr_spmv.launches}
    for name, n in used.items():
        assert (n > 0) == (name == res.spmv_backend), (name, n)
    if backend != "auto":
        assert res.spmv_backend == backend
    assert csr_spmm.launches > 0  # the scaling's row sums


def test_captures_reuse_one_warmup_stream_and_pool(cuda, monkeypatch):
    """The repair of the per-capture side stream: every capture of a solve
    (the autotune's probes, the chunk boundary) and of a second solve warms
    up on the device's one side stream and allocates from its one graph
    pool."""
    from hprlp_tpu_torch.solver import graph

    real_stream, real_pool = graph.warmup_stream, graph.graph_pool
    streams, pools = [], []
    monkeypatch.setattr(graph, "warmup_stream", lambda device=None: (
        streams.append(real_stream(device)) or streams[-1]))
    monkeypatch.setattr(graph, "graph_pool", lambda device=None: (
        pools.append(real_pool(device)) or pools[-1]))
    args = _arrays(m=300, n=1000, density=0.04)
    for _ in range(2):
        res = ht.solve(*args, ht.Parameters(verbose=False,
                                            use_presolve=False))
        assert res.status == "OPTIMAL"
    assert len(streams) >= 4 and len(pools) == len(streams)
    assert all(s is streams[0] for s in streams)
    assert all(p == pools[0] for p in pools)
    assert streams[0] != torch.cuda.current_stream()


def test_solves_in_one_process_keep_device_memory_flat(cuda):
    """Six solves of one LP in this process, with the autotune's probes and
    no call of server.release_device_memory: from the second solve on,
    the allocator's reserved memory stays within 32 MiB.  A new side
    stream per capture (a cuBLAS workspace each) and a private graph pool
    per capture grew it with every solve."""
    args = _arrays(m=3000, n=6000, density=0.003)
    reserved = []
    for _ in range(6):
        res = ht.solve(*args, ht.Parameters(verbose=False,
                                            use_presolve=False))
        assert res.status == "OPTIMAL"
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert autotune.autotune_backends.record is not None  # probes ran
    assert max(reserved[1:]) - min(reserved[1:]) <= 32 * 2**20, reserved


def test_the_card_refuses_the_eager_route_unasked(cuda):
    args, obj_c = _setup(torch.float32, cuda)
    with pytest.raises(ValueError, match="graph=False"):
        _run(args, obj_c, 0.0, 1, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_graph_equals_eager_bitwise(cuda, dtype):
    """B = 8 members, 2 frozen: four chunks replayed and four run eagerly
    give bitwise the same rows and state; the fused halves' launches are
    counted per replay."""
    B = 8
    A, AL, AU, l, u, c = _arrays(m=200, n=300, density=0.05)
    rng = np.random.default_rng(1)
    C = rng.normal(size=(300, B))
    tile = lambda v: np.tile(np.asarray(v)[:, None], (1, B))  # noqa: E731
    su = batched.setup_batched(A, C, tile(AL), tile(AU), tile(l), tile(u),
                               ht.Parameters(), cuda, dtype)
    lam = max(float(power_method(su.lp0)) * 1.01, 1e-12)

    def t(v):
        return torch.as_tensor(v, device=cuda).to(dtype)

    sigma = t(batched.initial_sigma(su))
    state = batched.init_batched_state(su.lp)
    active = torch.ones(B, dtype=torch.bool, device=cuda)
    active[[2, 5]] = False
    m0 = batched.initial_bmetrics(su.lp, su.row_norm, su.col_norm, state)
    scales = tuple(t(v) for v in (su.b_scale, su.c_scale, su.norm_b_org,
                                  su.norm_c_org, np.zeros(B)))
    args = (su.lp, su.row_norm, su.col_norm, state,
            bdl.init_batched_restart_dev(sigma, dtype), sigma,
            t(np.full(B, lam)), active, m0)
    eager = bdl.run_batched_superchunk(*args, 0, *scales, 0.0, 4, CHECK,
                                       False)
    graph = bdl.capture_batched_superchunk(*args, *scales, 0.0, CHECK, 4)
    assert graph.captured.per_replay["spmm_x_half"] == CHECK - 2
    replayed = bdl.run_batched_superchunk(*args, 0, *scales, 0.0, 4, CHECK,
                                          graph)
    assert eager[7] == replayed[7] == 4
    for k in bdl.STACK_KEYS:
        np.testing.assert_array_equal(eager[6][k], replayed[6][k], k)
    for f in dataclasses.fields(batched.BatchedState):
        assert torch.equal(getattr(eager[0], f.name),
                           getattr(replayed[0], f.name)), f.name
