"""The single-LP halves on the tiles on the CPU: the fused wrappers'
refusals (ops/spmv.py::tiled_x_half, tiled_y_half, tiled_half_epilogue),
their plain counterparts (the tiled kernel's plain version then the plain
ops of solver/chunk.py) against the JAX package's _x_half and _y_half, and
the half dispatch of solver/chunk.py as it runs on the card, each kernel
stood in by its plain version: on one card's tiles, on a one-rank gloo
column shard, and over 2 gloo ranks' column shards.  The kernels
themselves run on the card: tests/test_torch_tiled_halves_gpu.py.

Tolerances: against JAX, 1e-12 * max(1, max|v|) in f64 (the SpMV sums run
in another order); the dispatch and the ranks bitwise (two ranks' partial
products add in either order to the same bits).
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hprlp_tpu.ops.device_problem import build_device_problem as jax_build
from hprlp_tpu.ops.sparse import to_coo
from hprlp_tpu.solver import chunk as jchunk
from hprlp_tpu_torch import convert
from hprlp_tpu_torch.ops.spmv import (check_tiled_half_layout,
                                      tiled_half_epilogue, tiled_x_half,
                                      tiled_y_half)
from hprlp_tpu_torch.ops.tiles import build_tiles, tiled_spmv_reference
from hprlp_tpu_torch.parallel import distributed
from hprlp_tpu_torch.parallel.sharded import shard_matrix, shard_problem
from hprlp_tpu_torch.solver import chunk

import test_torch_tiled_halves_gpu as halves_gpu
from conftest import random_lp as jax_random_lp
from test_torch_parallel_ranks import one_rank_group  # noqa: F401 (fixture)
from test_torch_tiled_halves_gpu import (card_route, halves, plain_epilogue,
                                         shard_lp)

torch.set_num_threads(1)

F64 = torch.float64
# Tiles with one strip group and with several: narrow strips, so that the
# small LP has strips to group.
TILINGS = {"G1": {"strip_width": 32, "strip_groups": 1},
           "G3": {"strip_width": 32, "strip_groups": 3}}


def _with_tiles(lp, **kw):
    return dataclasses.replace(
        lp, A=lp.A.with_tiles(build_tiles(lp.A, **kw)),
        AT=lp.AT.with_tiles(build_tiles(lp.AT, **kw)))


# --- the wrappers' refusals -------------------------------------------------

def _small(dtype=F64):
    """A's tiles of a small LP and operands for a half over its rows."""
    lp = shard_lp(dtype=dtype)
    T = build_tiles(lp.A)
    rng = np.random.default_rng(3)

    def vec(n):
        return torch.as_tensor(rng.normal(size=n)).to(dtype)

    rows = tuple(vec(T.nrows) for _ in range(5))
    return T, vec(T.ncols), rows, torch.tensor(0.5, dtype=dtype), \
        torch.tensor(3, dtype=torch.int32)


@pytest.mark.parametrize("wrapper", ["x", "y", "epilogue_x", "epilogue_y"])
def test_fused_tiled_wrappers_refuse_cpu_tensors(wrapper):
    """No hidden fallback: the kernels take CUDA tensors only."""
    T, v, rows, scal, inner = _small()
    calls = {"x": lambda: tiled_x_half(T, v, *rows, scal, inner, 0),
             "y": lambda: tiled_y_half(T, v, *rows[:4], scal, inner, 0),
             "epilogue_x": lambda: tiled_half_epilogue(
                 "x", rows[0], rows, scal, inner, 0),
             "epilogue_y": lambda: tiled_half_epilogue(
                 "y", rows[0], rows[:4], scal, inner, 0)}
    with pytest.raises(ValueError, match="CUDA"):
        calls[wrapper]()


@pytest.mark.parametrize("stage", ["group_cluster", "block_x", "global_x",
                                   "cluster8_x"])
@pytest.mark.parametrize("half", ["x", "y"])
def test_fused_tiled_halves_run_on_the_main_stage_or_block_x(half, stage):
    """A fused half runs on the main stage (its default) or on block_x,
    the previous design kept as the yardstick; another stage is refused
    before anything else, and the two it takes still refuse CPU tensors
    (no fallback)."""
    from hprlp_tpu_torch.ops.spmv import HALF_STAGES

    T, v, rows, scal, inner = _small()
    fn = tiled_x_half if half == "x" else tiled_y_half
    args = rows if half == "x" else rows[:4]
    match = "CUDA" if stage in HALF_STAGES else "fused half runs on"
    with pytest.raises(ValueError, match=match):
        fn(T, v, *args, scal, inner, 0, stage=stage)


def _bad(case):
    """check_tiled_half_layout's arguments with one thing wrong, and the
    error it must raise."""
    T, v, rows, scal, inner = _small()
    args = {"T": T, "v": v, "half": "x", "rows": rows, "scal": scal,
            "inner": inner}
    if case == "row_shape":
        args["rows"] = (rows[0], rows[1][1:], *rows[2:])
        return args, ValueError, "shape"
    if case == "operand_shape":
        args["v"] = v[1:]
        return args, ValueError, "shape"
    if case == "row_count":
        args["rows"] = rows[:4]
        return args, ValueError, "row operands"
    if case == "misaligned_x":
        shifted = torch.empty(T.ncols + 1, dtype=F64)[1:]
        shifted.copy_(v)
        args["v"] = shifted
        return args, ValueError, "16-byte"
    if case == "row_dtype":
        args["rows"] = (rows[0].float(), *rows[1:])
        return args, TypeError, "float64"
    if case == "operand_dtype":
        args["v"] = v.float()
        return args, TypeError, "float32"
    if case == "scal_dtype":
        args["scal"] = scal.float()
        return args, TypeError, "scal"
    assert case == "inner_dtype"
    args["inner"] = inner.long()
    return args, TypeError, "int32"


@pytest.mark.parametrize("case", ["row_shape", "operand_shape", "row_count",
                                  "misaligned_x", "row_dtype",
                                  "operand_dtype", "scal_dtype",
                                  "inner_dtype"])
def test_fused_tiled_half_checks_refuse(case):
    """The device-independent checks the fused halves make before a launch:
    wrong shapes, a wrong number of row operands, misaligned x, wrong
    dtypes."""
    args, error, match = _bad(case)
    with pytest.raises(error, match=match):
        check_tiled_half_layout(**args)


# --- the plain counterpart against the JAX package ---------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX's padded LP, the port's copy of it), f64, unscaled."""
    lp_j, _ = jax_build(jax_random_lp(3, m=150, n=230, density=0.06),
                        dtype=np.float64)
    d = {"A": (*to_coo(lp_j.A), lp_j.m, lp_j.n),
         "AT": (*to_coo(lp_j.AT), lp_j.n, lp_j.m)}
    d.update({k: np.asarray(getattr(lp_j, k))
              for k in ("AL", "AU", "c", "l", "u")})
    return lp_j, convert.lp_device_from_numpy(d)


def _close(a, b, rtol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = rtol * max(1.0, float(np.abs(b).max()) if b.size else 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("t", [0, 5])
@pytest.mark.parametrize("tiling", sorted(TILINGS))
def test_plain_tiled_halves_match_jax(pair, tiling, t):
    """x_half_plain and y_half_plain on the tiles (tiled_spmv_reference,
    then the plain ops: what the fused halves compute) against JAX's
    _x_half and _y_half at the same operands, f64, one strip group and
    three."""
    lp_j, lp_t = pair
    lp_t = _with_tiles(lp_t, **TILINGS[tiling])
    groups = TILINGS[tiling]["strip_groups"]
    assert lp_t.A.tiles.n_groups == lp_t.AT.tiles.n_groups == groups
    rng = np.random.default_rng(21)
    x, last_x = rng.normal(size=lp_t.n), rng.normal(size=lp_t.n)
    y, last_y = rng.normal(size=lp_t.m), rng.normal(size=lp_t.m)
    sigma, lam_sigma, inner = 0.37, 1.9, 11
    f1, f2 = jchunk._halpern_factors(jnp.asarray(inner + t, jnp.int32),
                                     jnp.float64)
    xj, xhj, _, _ = jchunk._x_half(lp_j, jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(last_x), sigma, f1, f2)
    yj = jchunk._y_half(lp_j, jnp.asarray(y), xhj, jnp.asarray(last_y),
                        lam_sigma, f1, f2)[0]
    h = chunk.Halpern(torch.tensor(inner, dtype=torch.int32), t, F64)
    xt, xht = chunk.x_half_plain(lp_t, torch.as_tensor(x),
                                 torch.as_tensor(y), torch.as_tensor(last_x),
                                 torch.tensor(sigma, dtype=F64), h)
    yt = chunk.y_half_plain(lp_t, torch.as_tensor(y), xht,
                            torch.as_tensor(last_y),
                            torch.tensor(lam_sigma, dtype=F64), h)
    _close(xt.numpy(), xj, 1e-12, "x_new")
    _close(xht.numpy(), xhj, 1e-12, "x_hat")
    _close(yt.numpy(), yj, 1e-12, "y_new")


# --- the half dispatch, kernels stood in ------------------------------------

@pytest.mark.parametrize("tiling", sorted(TILINGS))
def test_card_route_on_one_cards_tiles_is_the_plain_halves(tiling):
    """On one card's tiles x_half and y_half run tiled_x_half and
    tiled_y_half (here their plain versions), bitwise the plain halves."""
    lp = _with_tiles(shard_lp(), **TILINGS[tiling])
    plain = halves(lp)
    calls = []
    with card_route(calls):
        routed = halves(lp)
    assert calls == ["tiled_x_half", "tiled_y_half"]
    for a, b in zip(routed, plain):
        np.testing.assert_array_equal(a, b)


def test_card_route_on_a_column_shard_is_the_one_card_halves(
        one_rank_group):
    """On a one-rank column shard each half is the sharded product (the
    tiled kernel on the slice, one all-reduce) and one epilogue, bitwise
    the one card's plain halves on the whole tiles."""
    lp = shard_lp()
    whole = halves(_with_tiles(lp))
    calls = []
    with card_route(calls):
        routed = halves(shard_problem(lp, 0, 1))
    assert calls == ["tiled_half_epilogue_x", "tiled_half_epilogue_y"]
    for a, b in zip(routed, whole):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def two_ranks():
    """Every rank's column_shard_halves() over 2 gloo ranks."""
    return distributed.launch(halves_gpu.column_shard_halves, world=2,
                              device_type="cpu", timeout=300)


def _two_rank_reference():
    """What both ranks must give: each half's product as the two slices'
    plain partial products summed, then the plain update."""
    lp = shard_lp()
    rng = np.random.default_rng(8)  # halves()'s draw, in its order
    x, last_x, y, last_y = (torch.as_tensor(rng.normal(size=n))
                            for n in (lp.n, lp.n, lp.m, lp.m))
    h_args = (torch.tensor(halves_gpu.INNER, dtype=torch.int32), 3)

    def product(M, v):
        parts = []
        for r in range(2):
            S = shard_matrix(M, r, 2)
            parts.append(tiled_spmv_reference(S.tiles,
                                              v[S.shard.c0:S.shard.c1]))
        return parts[0] + parts[1]

    x_new, x_hat = plain_epilogue(
        "x", product(lp.AT, y), (x, last_x, lp.c, lp.l, lp.u),
        torch.tensor(halves_gpu.SIGMA, dtype=F64), *h_args)
    y_new = plain_epilogue(
        "y", product(lp.A, x_hat), (y, last_y, lp.AL, lp.AU),
        torch.tensor(halves_gpu.LAM_SIGMA, dtype=F64), *h_args)
    return [v.numpy() for v in (x_new, x_hat, y_new)]


@pytest.mark.parametrize("route", ["plain", "routed"])
@pytest.mark.parametrize("rank", [0, 1])
def test_two_ranks_halves_on_column_shards_are_bitwise(two_ranks, rank,
                                                       route):
    """Over 2 gloo ranks each rank's x_half and y_half on its column shards,
    by the CPU's plain dispatch and by the card's route (one epilogue per
    half after the all-reduce), are bitwise the sum of the two slices'
    partial products followed by the plain update; and within 1e-12 of one
    card's halves on the whole tiles."""
    got = two_ranks[rank]
    want = _two_rank_reference()
    for a, b in zip(got[route], want):
        np.testing.assert_array_equal(a, b)
    if route == "routed":
        assert got["calls"] == ["tiled_half_epilogue_x",
                                "tiled_half_epilogue_y"]
    whole = halves(_with_tiles(shard_lp()))
    for a, b, what in zip(got[route], whole, ("x_new", "x_hat", "y_new")):
        _close(a, b, 1e-12, what)


# --- the mesh's epilogue: its launch plan -----------------------------------

SMS = 132  # the H100's SMs


def _covered(P, n):
    """How many times the kernel's index arithmetic (csrc/spmv_tiled.cu
    half_epilogue_kernel: row i = block * threads + thread, then strides
    of grid * threads) writes each of n rows under plan P."""
    tid = np.arange(P.grid * P.threads)
    rows = [tid + p * P.grid * P.threads for p in range(P.passes + 1)]
    rows = np.concatenate(rows)
    return np.bincount(rows[rows < n], minlength=n)


@pytest.mark.parametrize("blocks_per_sm", [8, 5, 1])
@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 70001, 65536, 131072,
                               262144, 524288, 1056 * 256 - 1, 1056 * 256,
                               1056 * 256 + 1, 3145728])
def test_epilogue_plan_covers_every_row_once(n, blocks_per_sm):
    """ops/spmv.py::epilogue_plan: blocks of 256, the grid sized to the
    rows and capped at one wave, the passes that cover the rest; the
    kernel's index arithmetic on that plan writes every row exactly
    once."""
    from hprlp_tpu_torch.ops.spmv import EPI_THREADS, epilogue_plan

    P = epilogue_plan(n, SMS, blocks_per_sm)
    assert P.threads == EPI_THREADS == 256
    assert 1 <= P.grid <= SMS * blocks_per_sm
    assert P.grid == max(1, min(-(-n // 256), SMS * blocks_per_sm))
    assert (P.passes - 1) * P.grid * 256 < n <= P.passes * P.grid * 256 \
        or n == P.passes == 0
    assert np.array_equal(_covered(P, n), np.ones(n, dtype=np.int64))


@pytest.mark.parametrize("cell", [
    # (rows, blocks an SM): (grid, passes)
    ((65536, 8), (256, 1)),     # sparse_large y
    ((131072, 8), (512, 1)),    # sparse_large x
    ((262144, 8), (1024, 1)),   # sparse_huge y
    ((524288, 8), (1056, 2)),   # sparse_huge x: one wave, then a stride
    ((524288, 6), (792, 3)),    # the same at 6 blocks an SM
    ((3145728, 8), (1056, 12)),  # the banded giant's x
], ids=["large_y", "large_x", "huge_y", "huge_x", "huge_x_6", "giant_x"])
def test_epilogue_plan_at_the_mesh_sizes(cell):
    """The plan's grid at the sizes a mesh's epilogue runs: one block a
    256 rows up to one wave of resident blocks."""
    from hprlp_tpu_torch.ops.spmv import epilogue_plan

    (n, per_sm), want = cell
    P = epilogue_plan(n, SMS, per_sm)
    assert (P.grid, P.passes) == want


def test_epilogue_plan_refuses_what_the_kernel_does_not_take():
    from hprlp_tpu_torch.ops.spmv import epilogue_plan

    with pytest.raises(ValueError, match="plan"):
        epilogue_plan(-1, SMS, 8)
    with pytest.raises(ValueError, match="plan"):
        epilogue_plan(10, 0, 8)
    with pytest.raises(RuntimeError, match="fits"):
        epilogue_plan(10, SMS, 0)
