"""The single-LP middle iteration's halves fused into the tiled SpMV
(csrc/spmv_tiled.cu: ops/spmv.py::tiled_x_half, tiled_y_half) and the
column-sharded mesh's epilogue (tiled_half_epilogue) on the card, and the
helpers that tests/test_torch_tiled_halves.py runs on the CPU: the
epilogue's plain version, the half dispatch of the card with each kernel
stood in by its plain version, and the halves on a rank's column shards.

The card's tests need a CUDA device (the kernels have no CPU mode) and
skip without one.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_tiled_halves_gpu.py

Tolerances: bitwise throughout.  A fused half is the tiled kernel's row
sums (the same kernel, the same order) followed by csrc/hpr_half.cuh's
update, whose rounding is PyTorch's elementwise ops'; the epilogue is
that update alone; the main stage's halves (one cluster of the G
strip-group blocks per row chunk) are block_x's (partials through HBM,
then group_sum_kernel) on the same tiles.
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from hprlp_tpu_torch.ops.device_problem import host_csr, upload_problem
from hprlp_tpu_torch.ops.sparse import spmv_backend
from hprlp_tpu_torch.ops.spmv import (BLOCK_X_HALVES, group_sum_kernel,
                                      tiled_half_epilogue, tiled_spmv,
                                      tiled_x_half, tiled_y_half)
from hprlp_tpu_torch.ops.tiles import tiled_spmv_reference
from hprlp_tpu_torch.parallel.sharded import shard_problem
from hprlp_tpu_torch.solver import chunk
from hprlp_tpu_torch.solver.graph import CapturedStep

from test_torch_parallel_ranks import random_problem
from test_torch_tiles_gpu import (GROUP_CASES, group_case_shape, make_case,
                                  make_group_case)

DTYPES = [torch.float32, torch.float64]
SIGMA, LAM_SIGMA, INNER = 0.37, 1.9, 11
# The tiles cases of tests/test_torch_tiles_gpu.py the halves run on: one
# strip group and several (strip_groups, uneven_groups), no entries,
# empty and padding rows, a long row, many strips and blocks.
HALF_CASES = ["random", "empty_rows", "padding_rows", "nnz0", "long_row",
              "many_strips_blocks", "strip_groups", "uneven_groups"]


# --- helpers the CPU tests share --------------------------------------------

def plain_epilogue(half, s, rows, scal, inner, t):
    """tiled_half_epilogue's plain version: solver/chunk.py::x_update or
    y_update on the summed product s, rows as the wrapper takes them."""
    f = chunk.Halpern(inner, t, s.dtype).factors
    if half == "x":
        x, last_x, c, l, u = rows
        return chunk.x_update(types.SimpleNamespace(c=c, l=l, u=u), x, s,
                              last_x, scal, *f)[:2]
    y, last_y, AL, AU = rows
    return chunk.y_update(types.SimpleNamespace(AL=AL, AU=AU), y, s, last_y,
                          scal, *f)[0]


@contextlib.contextmanager
def card_route(calls):
    """solver/chunk.py's half dispatch as it runs on the card with A on the
    tiles, each kernel stood in by its plain version (the tiled kernel's by
    tiled_spmv_reference, the update's by plain_epilogue) and named in
    `calls` when it runs."""
    def fused(M, v):
        return spmv_backend(M) == "tiled"

    def x_half(T, y, x, last_x, c, l, u, sigma, inner, t):
        calls.append("tiled_x_half")
        return plain_epilogue("x", tiled_spmv_reference(T, y),
                              (x, last_x, c, l, u), sigma, inner, t)

    def y_half(T, x_hat, y, last_y, AL, AU, lam_sigma, inner, t):
        calls.append("tiled_y_half")
        return plain_epilogue("y", tiled_spmv_reference(T, x_hat),
                              (y, last_y, AL, AU), lam_sigma, inner, t)

    def epilogue(half, s, rows, scal, inner, t):
        calls.append(f"tiled_half_epilogue_{half}")
        return plain_epilogue(half, s, rows, scal, inner, t)

    stand_ins = {"_fused": fused, "tiled_x_half": x_half,
                 "tiled_y_half": y_half, "tiled_half_epilogue": epilogue}
    saved = {k: getattr(chunk, k) for k in stand_ins}
    for k, v in stand_ins.items():
        setattr(chunk, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(chunk, k, v)


def halves(lp, seed=8, t=3):
    """chunk.x_half, then chunk.y_half on its x_hat, at operands drawn from
    `seed` (x, last_x, y, last_y), sigma SIGMA, lambda sigma LAM_SIGMA and
    the counter INNER + t: numpy (x_new, x_hat, y_new)."""
    rng = np.random.default_rng(seed)
    dtype, dev = lp.c.dtype, lp.c.device

    def vec(n):
        return torch.as_tensor(rng.normal(size=n), device=dev).to(dtype)

    x, last_x, y, last_y = vec(lp.n), vec(lp.n), vec(lp.m), vec(lp.m)
    h = chunk.Halpern(torch.tensor(INNER, dtype=torch.int32, device=dev), t,
                      dtype)
    x_new, x_hat = chunk.x_half(lp, x, y, last_x,
                                torch.tensor(SIGMA, dtype=dtype, device=dev),
                                h)
    y_new = chunk.y_half(lp, y, x_hat, last_y,
                         torch.tensor(LAM_SIGMA, dtype=dtype, device=dev), h)
    return [v.cpu().numpy() for v in (x_new, x_hat, y_new)]


def shard_lp(seed=11, dtype=torch.float64, device="cpu"):
    """random_problem(seed)'s LP (150 x 230, unscaled) laid out on
    `device`."""
    problem = random_problem(seed, m=150, n=230, density=0.06)
    return upload_problem(problem, *host_csr(problem), dtype=dtype,
                          device=device)[0]


def column_shard_halves(seed=11):
    """What a rank of the default group runs: halves() on its column shards
    of shard_lp(seed) (f64, CPU), by the CPU's plain dispatch and by the
    card's route with its kernels stood in (card_route).  Returns {"plain",
    "routed": (x_new, x_hat, y_new), "calls": the stand-ins run}."""
    import torch.distributed as dist

    lp = shard_problem(shard_lp(seed), dist.get_rank(),
                       dist.get_world_size())
    calls = []
    plain = halves(lp)
    with card_route(calls):
        routed = halves(lp)
    return {"plain": plain, "routed": routed, "calls": calls}


# --- on the card ------------------------------------------------------------

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(T, dtype, device, infinite=False):
    """One x-half's and one y-half's operands over T's rows (the gathered
    operand over its columns), from a seeded draw; `infinite`: some bounds
    infinite, as an LP's free variables and one-sided rows have them."""
    rng = np.random.default_rng(4)

    def vec(n, scale=1.0):
        return torch.as_tensor(rng.normal(size=n) * scale,
                               device=device).to(dtype)

    n = T.nrows
    lo = vec(n)
    o = {"v": vec(T.ncols), "x": vec(n), "last_x": vec(n), "c": vec(n),
         "l": lo, "u": lo + torch.abs(vec(n)), "AL": vec(n) - 1.0,
         "AU": vec(n) + 1.0, "y": vec(n), "last_y": vec(n),
         "sigma": torch.tensor(0.73, dtype=dtype, device=device),
         "lam_sigma": torch.tensor(2.9, dtype=dtype, device=device),
         "inner": torch.tensor(5, dtype=torch.int32, device=device)}
    if infinite:
        for k, every in (("l", 3), ("u", 4), ("AL", 3), ("AU", 5)):
            o[k][::every] = -np.inf if k in ("l", "AL") else np.inf
    return o


def _x_rows(o):
    return (o["x"], o["last_x"], o["c"], o["l"], o["u"])


def _y_rows(o):
    return (o["y"], o["last_y"], o["AL"], o["AU"])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", HALF_CASES)
def test_fused_tiled_halves_equal_store_plus_plain_ops(cuda, case, dtype):
    """tiled_x_half / tiled_y_half bitwise the kernel's store (tiled_spmv)
    followed by the plain ops, at several t; one launch each."""
    _, T, _ = make_case(case, dtype, cuda)
    o = _operands(T, dtype, cuda, infinite=case == "random")
    for t in (0, 3, 147):
        before = (tiled_x_half.launches, tiled_y_half.launches)
        x_new, x_hat = tiled_x_half(T, o["v"], *_x_rows(o), o["sigma"],
                                    o["inner"], t)
        y_new = tiled_y_half(T, o["v"], *_y_rows(o), o["lam_sigma"],
                             o["inner"], t)
        s = tiled_spmv(T, o["v"])
        xp, xhp = plain_epilogue("x", s, _x_rows(o), o["sigma"], o["inner"],
                                 t)
        yp = plain_epilogue("y", s, _y_rows(o), o["lam_sigma"], o["inner"],
                            t)
        torch.cuda.synchronize()
        assert torch.equal(x_new, xp) and torch.equal(x_hat, xhp), t
        assert torch.equal(y_new, yp), t
        assert (tiled_x_half.launches, tiled_y_half.launches) == (
            before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("half", ["x", "y"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(GROUP_CASES) + ["uneven_groups"])
def test_cluster_route_halves_are_bitwise_block_x(cuda, case, dtype, half):
    """Each fused half on the main stage bitwise block_x's on the same
    tiles at G = 1 .. 8 (uneven groups, empty padded chunks, chunks of
    fewer rows than G), infinite bounds included: one launch a call, no
    group-sum pass (block_x takes one at G > 1), and only block_x's call
    counted among the halves on block_x."""
    _, T, _ = (make_group_case(case, dtype, cuda) if case in GROUP_CASES
               else make_case(case, dtype, cuda))
    G = group_case_shape(T)[0]
    o = _operands(T, dtype, cuda, infinite=True)
    if half == "x":
        def run(stage):
            return tiled_x_half(T, o["v"], *_x_rows(o), o["sigma"],
                                o["inner"], 7, stage=stage)
        counter = tiled_x_half
    else:
        def run(stage):
            return (tiled_y_half(T, o["v"], *_y_rows(o), o["lam_sigma"],
                                 o["inner"], 7, stage=stage),)
        counter = tiled_y_half
    old = BLOCK_X_HALVES[half]

    def counts():
        return (counter.launches, group_sum_kernel.launches, old.launches)

    before = counts()
    got = run("group_cluster")
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 0, 0)
    want = run("block_x")
    assert tuple(a - b for a, b in zip(counts(), before)) == (
        2, int(G > 1), 1)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("half", ["x", "y"])
def test_epilogue_equals_the_plain_update(cuda, half, dtype):
    """tiled_half_epilogue on a given summed product bitwise its plain
    version, infinite bounds included; one launch, counted apart from the
    fused halves."""
    _, T, _ = make_case("random", dtype, cuda)
    o = _operands(T, dtype, cuda, infinite=True)
    s = torch.as_tensor(np.random.default_rng(5).normal(size=T.nrows) * 3,
                        device=cuda).to(dtype)
    rows, scal = ((_x_rows(o), o["sigma"]) if half == "x"
                  else (_y_rows(o), o["lam_sigma"]))
    before = (tiled_half_epilogue.launches, tiled_x_half.launches,
              tiled_y_half.launches)
    got = tiled_half_epilogue(half, s, rows, scal, o["inner"], 9)
    want = plain_epilogue(half, s, rows, scal, o["inner"], 9)
    torch.cuda.synchronize()
    got, want = ((got, want) if half == "x" else ((got,), (want,)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tiled_half_epilogue.launches, tiled_x_half.launches,
            tiled_y_half.launches) == (before[0] + 1, *before[1:])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("groups", [1, 4], ids=["G1", "G4"])
def test_fused_tiled_chunk_replay_equals_eager_and_plain(cuda, dtype,
                                                         groups):
    """A 150-iteration run_chunk on the tiles (A's and A^T's with `groups`
    strip groups): the fused halves (one launch each per middle iteration,
    the tiled SpMV's own 8: the first and last iterations' halves, the
    fixed-point gap and the residuals) bitwise the plain halves, and its
    CUDA graph's replay bitwise the eager run."""
    from hprlp_tpu_torch.ops.tiles import build_tiles
    from hprlp_tpu_torch.prof import prof_loop
    from hprlp_tpu_torch.prof.problems import random_lp

    loop = prof_loop.Loop(random_lp(4096, 8192, 12, seed=3), dtype,
                          graph=False, backend="tiled")
    lp = loop.lp
    kw = {"strip_groups": groups, "strip_width": None if groups == 1
          else 1024}  # 8 and 4 strips of A and A^T to group
    lp = dataclasses.replace(lp, A=lp.A.with_tiles(build_tiles(lp.A, **kw)),
                             AT=lp.AT.with_tiles(build_tiles(lp.AT, **kw)))
    assert lp.A.tiles.n_groups == groups and lp.AT.tiles.n_groups == groups
    args = (lp, loop.scal, loop.state, loop.sigma, loop.lam,
            torch.tensor(False, device=cuda), 150)
    before = (tiled_spmv.launches, tiled_x_half.launches,
              tiled_y_half.launches)
    st_f, m_f = chunk.run_chunk(*args)
    assert (tiled_spmv.launches - before[0], tiled_x_half.launches
            - before[1], tiled_y_half.launches - before[2]) == (8, 148, 148)
    fused_x, fused_y = chunk.x_half, chunk.y_half
    try:
        chunk.x_half, chunk.y_half = chunk.x_half_plain, chunk.y_half_plain
        st_p, m_p = chunk.run_chunk(*args)
    finally:
        chunk.x_half, chunk.y_half = fused_x, fused_y
    step = CapturedStep(lambda: chunk.run_chunk(*args))
    assert step.per_replay == {"tiled_spmv": 8, "tiled_x_half": 148,
                               "tiled_y_half": 148}
    step.replay()
    st_g, m_g = step.out
    torch.cuda.synchronize()
    for f in ("x", "y", "x_bar", "y_bar", "z_bar", "y_obj", "inner"):
        assert torch.equal(getattr(st_f, f), getattr(st_p, f)), f
        assert torch.equal(getattr(st_f, f), getattr(st_g, f)), f
    for k in m_f:
        assert torch.equal(m_f[k], m_p[k]) and torch.equal(m_f[k], m_g[k]), k


def test_halves_dispatch_to_the_tiled_kernel_on_the_card(cuda):
    """chunk.x_half / y_half on an LP on the tiles launch the fused tiled
    halves, never the CSR ones, and give the plain halves' bits."""
    from hprlp_tpu_torch.ops.device_problem import attach_tiles
    from hprlp_tpu_torch.ops.spmv import spmv_x_half, spmv_y_half
    from hprlp_tpu_torch.ops.tiles import build_tiles

    lp = shard_lp(device=cuda)
    lp = attach_tiles(lp, build_tiles(lp.A), build_tiles(lp.AT))
    before = (tiled_x_half.launches, tiled_y_half.launches,
              spmv_x_half.launches, spmv_y_half.launches)
    fused = halves(lp)
    assert (tiled_x_half.launches, tiled_y_half.launches,
            spmv_x_half.launches, spmv_y_half.launches) == (
        before[0] + 1, before[1] + 1, *before[2:])
    try:
        saved = chunk.x_half, chunk.y_half
        chunk.x_half, chunk.y_half = chunk.x_half_plain, chunk.y_half_plain
        plain = halves(lp)
    finally:
        chunk.x_half, chunk.y_half = saved
    for a, b in zip(fused, plain):
        np.testing.assert_array_equal(a, b)


def test_tiled_halves_reject_bad_arguments(cuda):
    _, T, _ = make_case("random", torch.float32, cuda)
    o = _operands(T, torch.float32, cuda)
    with pytest.raises(TypeError, match="int32"):
        tiled_x_half(T, o["v"], *_x_rows(o), o["sigma"], o["inner"].long(),
                     0)
    with pytest.raises(ValueError, match="shape"):
        tiled_y_half(T, o["v"], o["y"], o["last_y"], o["AL"][1:], o["AU"],
                     o["lam_sigma"], o["inner"], 0)
    with pytest.raises(TypeError):
        tiled_y_half(T, o["v"], *_y_rows(o), o["lam_sigma"].double(),
                     o["inner"], 0)
    shifted = torch.empty(T.ncols + 1, device=cuda)[1:]
    shifted.copy_(o["v"])
    with pytest.raises(ValueError, match="16-byte"):
        tiled_x_half(T, shifted, *_x_rows(o), o["sigma"], o["inner"], 0)
    with pytest.raises(ValueError, match="row operands"):
        tiled_half_epilogue("x", o["x"], _y_rows(o), o["sigma"], o["inner"],
                            0)
    with pytest.raises(ValueError, match="fused half runs on"):
        tiled_x_half(T, o["v"], *_x_rows(o), o["sigma"], o["inner"], 0,
                     stage="global_x")
