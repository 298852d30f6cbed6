"""The "gather" backend's CSR kernel (csrc/spmv_csr.cu) on the CPU: its
row-block plan (ops/spmv.py::row_blocks), its plain version on that plan
(csr_spmv_plain, the kernel's own summation order) against spmv_reference
and against the JAX package's gather SpMV, the wrappers' refusals, and the
single-LP middle iteration's half dispatch (solver/chunk.py::x_half,
y_half), which on the CPU must be bitwise the plain halves it replaced.
The kernel itself runs on the card: tests/test_torch_spmv_csr_gpu.py.

Tolerances: the plain version on the plan against spmv_reference and
JAX's gather SpMV, 1e-12 * max(1, max|y|) in f64 (the sums run in other
orders); the half dispatch bitwise.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

from hprlp_tpu.ops.device_problem import build_device_problem as jax_build
from hprlp_tpu.ops.sparse import spmv as jax_spmv
from hprlp_tpu.ops.sparse import to_coo
from hprlp_tpu.problem import LpProblem as JaxLpProblem
from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops import spmv as spmv_mod
from hprlp_tpu_torch.ops.sparse import spmv_backend, with_spmv_backend
from hprlp_tpu_torch.ops.spmv import (CSR_BLOCK, RowBlocks, csr_cap,
                                      check_blocks, csr_spmv,
                                      csr_spmv_plain, csr_spmv_rowgroup,
                                      library_path, row_blocks,
                                      spmv_reference, spmv_x_half,
                                      spmv_y_half)
from hprlp_tpu_torch.ops.tiles import build_tiles
from hprlp_tpu_torch.solver import chunk

from test_torch_spmv_csr_gpu import CASES, CSR_CAP

torch.set_num_threads(1)

F64 = torch.float64



def _port(A, dtype=F64):
    C = A.tocoo()
    return csr_from_coo(C.row, C.col, C.data, A.shape[0], A.shape[1], dtype,
                        "cpu")


def _assert_close(y, y_ref, tol):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    scale = max(1.0, float(np.abs(y_ref).max(initial=0.0)))
    assert np.abs(y - y_ref).max(initial=0.0) <= tol * scale


@pytest.mark.parametrize("cap,max_rows", [(None, CSR_BLOCK), (8, 4)],
                         ids=["kernel", "small"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_row_blocks_cover_every_entry_once(case, cap, max_rows):
    """The blocks are consecutive row ranges that cover every row and, by
    their entry ranges, every entry exactly once; a block of short rows
    holds fewer than 2 * cap entries and at most max_rows rows; a row
    longer than cap is a block alone."""
    A = CASES[case]()
    M = _port(A)
    P = row_blocks(M, cap=cap, max_rows=max_rows)
    assert P.cap == (csr_cap(F64) if cap is None else cap)
    cap = P.cap
    row0 = P.row0.numpy().astype(np.int64)
    ent0 = P.ent0.numpy().astype(np.int64)
    assert P.row0.dtype == P.ent0.dtype == torch.int32
    assert row0[0] == 0 and row0[-1] == A.shape[0]
    assert (np.diff(row0) > 0).all()
    np.testing.assert_array_equal(ent0, A.indptr[row0])
    assert P.nbytes == 8 * (P.n_blocks + 1)
    covered = np.zeros(A.nnz, np.int64)
    for b in range(P.n_blocks):
        covered[ent0[b]:ent0[b + 1]] += 1
        rows, ents = row0[b + 1] - row0[b], ent0[b + 1] - ent0[b]
        lengths = np.diff(A.indptr[row0[b]:row0[b + 1] + 1])
        if (lengths > cap).any():
            assert rows == 1
        else:
            assert ents < 2 * cap and rows <= max_rows
    assert (covered == 1).all()


def test_row_blocks_of_no_rows():
    M = csr_from_coo([], [], [], 0, 5, F64, "cpu")
    P = row_blocks(M)
    assert P.n_blocks == 0 and P.row0.tolist() == [0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_on_the_plan_matches_reference(case):
    """f64: csr_spmv_plain (the kernel's order on the plan) against
    spmv_reference (CSR order by index_add_) and scipy, to 1e-12."""
    A = CASES[case]()
    M = with_spmv_backend(_port(A), "gather")
    x = np.random.default_rng(9).normal(size=A.shape[1])
    y = csr_spmv_plain(M, torch.as_tensor(x))
    assert y.dtype == F64 and y.shape == (A.shape[0],)
    _assert_close(y.numpy(), spmv_reference(M, torch.as_tensor(x)).numpy(),
                  1e-12)
    _assert_close(y.numpy(), A @ x, 1e-12)


def test_plain_sums_short_rows_in_csr_order():
    """A short row sums its rounded products one add at a time from +0:
    f32 (1e8 + 1) - 1e8 in that order gives 0, where a pairwise or
    reversed order gives 1."""
    A = sp.csr_matrix(np.array([[1e8, 1.0, -1e8, 0.0]], np.float64))
    M = _port(A, torch.float32)
    y = csr_spmv_plain(M, torch.ones(4))
    assert float(y[0]) == 0.0


def test_plain_sums_a_long_row_by_strided_partials_and_a_tree():
    """A row of more than CSR_CAP entries: CSR_BLOCK strided partials in
    entry order, then a tree, in f32 -- the kernel's order, spelled out
    here with numpy."""
    rng = np.random.default_rng(12)
    n = 3 * CSR_CAP + 5
    vals = rng.normal(size=n).astype(np.float32) * np.float32(1e3)
    A = sp.csr_matrix((vals, (np.zeros(n, int), np.arange(n))), shape=(1, n))
    x = rng.normal(size=n).astype(np.float32)
    y = csr_spmv_plain(_port(A, torch.float32), torch.as_tensor(x))
    prod = vals * x
    part = np.zeros(CSR_BLOCK, np.float32)
    for k in range(n):
        part[k % CSR_BLOCK] = np.float32(part[k % CSR_BLOCK] + prod[k])
    w = CSR_BLOCK // 2
    while w:
        part[:w] = part[:w] + part[w:2 * w]
        w //= 2
    assert float(y[0]) == float(part[0])


def _jax_pair(A, seed):
    """A as the JAX package lays it out (default "gather" backend), and the
    port's CSR of the same padded positions."""
    m, n = A.shape
    rng = np.random.default_rng(seed)
    inf = np.full(m, np.inf)
    prob = JaxLpProblem.from_arrays(A.tocsr(), -inf, inf, -np.ones(n),
                                    np.ones(n), rng.normal(size=n))
    lp_j, _ = jax_build(prob, dtype=np.float64)
    assert lp_j.A.backend == "gather"
    rows, cols, vals = to_coo(lp_j.A)
    M = with_spmv_backend(csr_from_coo(rows, cols, vals, lp_j.m, lp_j.n,
                                       F64, "cpu"), "gather")
    return lp_j, M


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_on_the_plan_matches_jax_gather_spmv(case):
    """f64: the same x through hprlp_tpu.ops.sparse.spmv on the gather
    backend and through csr_spmv_plain, to 1e-12."""
    lp_j, M = _jax_pair(CASES[case](), 2)
    x = np.random.default_rng(3).normal(size=M.ncols)
    y_j = np.asarray(jax_spmv(lp_j.A, jnp.asarray(x)))
    _assert_close(csr_spmv_plain(M, torch.as_tensor(x)).numpy(), y_j, 1e-12)


def test_gather_backend_attaches_the_plan_and_keeps_it():
    """with_spmv_backend("gather") attaches the plan; new values (the
    scaling's) keep it, since it holds none."""
    M = _port(CASES["random"]())
    assert M.blocks is None
    G = with_spmv_backend(M, "gather")
    assert isinstance(G.blocks, RowBlocks) and spmv_backend(G) == "gather"
    assert G.with_vals(G.vals * 2).blocks is G.blocks
    assert with_spmv_backend(G, "gather").blocks is G.blocks


def test_wrappers_refuse_cpu_tensors_and_a_missing_plan():
    """No hidden fallback: the kernels take CUDA tensors only; a matrix
    without its plan, or with misaligned entry arrays, is refused."""
    M = with_spmv_backend(_port(CASES["tiny"]()), "gather")
    x = torch.ones(3, dtype=F64)
    for call in (lambda: csr_spmv(M, x),
                 lambda: csr_spmv_rowgroup(M, x),
                 lambda: spmv_x_half(M, x, x, x, x, x, x,
                                     torch.tensor(1.0, dtype=F64),
                                     torch.tensor(0, dtype=torch.int32), 0),
                 lambda: spmv_y_half(M, x, x, x, x, x,
                                     torch.tensor(1.0, dtype=F64),
                                     torch.tensor(0, dtype=torch.int32), 0)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    bare = _port(CASES["tiny"]())
    with pytest.raises(ValueError, match="row-block plan"):
        check_blocks(bare, x)
    big = with_spmv_backend(_port(CASES["random"]()), "gather")
    shifted = big.with_vals(torch.cat([torch.zeros(1, dtype=F64),
                                       big.vals])[1:])
    with pytest.raises(ValueError, match="16-byte"):
        check_blocks(shifted, torch.ones(big.ncols, dtype=F64))


def _half_args(half, dtype=F64):
    """A plan-carrying matrix (A^T for the x-half, A for the y-half), its
    gathered operand, its rows {name: tensor} in HALF_ROWS' order, scal
    and inner, all valid and on the CPU."""
    A = CASES["random"]()
    M = with_spmv_backend(_port(A.T.tocsr() if half == "x" else A, dtype),
                          "gather")
    rng = np.random.default_rng(21)

    def vec(n):
        return torch.as_tensor(rng.normal(size=n)).to(dtype)

    rows = {k: vec(M.nrows) for k in spmv_mod.HALF_ROWS[half]}
    return (M, vec(M.ncols), rows, torch.tensor(0.5, dtype=dtype),
            torch.tensor(3, dtype=torch.int32))


HALF_FAULTS = {
    "valid": (None, None),
    "row_shape": (ValueError, "contiguous of shape"),
    "row_strided": (ValueError, "contiguous of shape"),
    "row_dtype": (TypeError, "must be torch.float64"),
    "operand_shape": (ValueError, "contiguous of shape"),
    "operand_dtype": (TypeError, "matrix values"),
    "scal_shape": (ValueError, "scal"),
    "scal_dtype": (TypeError, "scal"),
    "inner_dtype": (TypeError, "int32"),
    "no_plan": (ValueError, "row-block plan"),
    "wrong_cap": (ValueError, "windows of"),
    "misaligned": (ValueError, "16-byte"),
}


@pytest.mark.parametrize("half", ["x", "y"])
@pytest.mark.parametrize("fault", sorted(HALF_FAULTS))
def test_half_checks_past_the_device(monkeypatch, half, fault):
    """The fused halves' checks beyond the device's type (stood in for
    here, as the card would pass it), each fault alone: the rows, scal and
    inner against the gathered operand and A's rows, the operand against
    A's columns, and the plan (its presence, its windows, 16-byte aligned
    entry arrays)."""
    monkeypatch.setattr(spmv_mod, "_check_cuda", lambda x: None)
    M, v, rows, scal, inner = _half_args(half)
    first = spmv_mod.HALF_ROWS[half][1]
    if fault == "row_shape":
        rows[first] = rows[first][1:]
    elif fault == "row_strided":
        rows[first] = torch.stack([rows[first]] * 2, 1)[:, 0]
    elif fault == "row_dtype":
        rows[first] = rows[first].float()
    elif fault == "operand_shape":
        v = torch.cat([v, v])
    elif fault == "operand_dtype":
        v = v.float()
    elif fault == "scal_shape":
        scal = scal.reshape(1)
    elif fault == "scal_dtype":
        scal = scal.float()
    elif fault == "inner_dtype":
        inner = inner.long()
    elif fault == "no_plan":
        M = dataclasses.replace(M, blocks=None)
    elif fault == "wrong_cap":
        M = dataclasses.replace(M, blocks=row_blocks(M, cap=512))
    elif fault == "misaligned":
        M = M.with_vals(torch.cat([torch.zeros(1, dtype=F64), M.vals])[1:])
    error, match = HALF_FAULTS[fault]
    if error is None:
        spmv_mod.check_half_args(M, v, rows, scal, inner)
        return
    with pytest.raises(error, match=match):
        spmv_mod.check_half_args(M, v, rows, scal, inner)


@pytest.mark.parametrize("half", ["x", "y"])
def test_failed_build_of_the_fused_halves_raises(monkeypatch, half):
    """A fused half whose kernel does not build raises from its wrapper,
    runs nothing in its place, and its launch count stays."""
    def no_build(source=None, ptxas_log=None):
        raise RuntimeError("nvcc failed (1): stand-in")

    monkeypatch.setattr(spmv_mod, "build", no_build)
    monkeypatch.setattr(spmv_mod, "check_half_args", lambda *a: None)
    spmv_mod._library.cache_clear()
    M, v, rows, scal, inner = _half_args(half)
    fn = spmv_x_half if half == "x" else spmv_y_half
    before = fn.launches
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fn(M, v, *rows.values(), scal, inner, 0)
    finally:
        spmv_mod._library.cache_clear()
    assert fn.launches == before


def test_library_path_covers_included_headers(tmp_path):
    """A source's library name changes with a header it includes (the
    fused halves' csrc/hpr_half.cuh), so a stale build is never loaded."""
    (tmp_path / "half.cuh").write_text("// one\n")
    src = tmp_path / "kernel.cu"
    src.write_text('#include "half.cuh"\n')
    before = library_path(str(src))
    (tmp_path / "half.cuh").write_text("// two\n")
    assert library_path(str(src)) != before


# ------------------------------------------------------- the half dispatch

def _lp(backend):
    """A small padded LP with its SpMV on `backend` (CPU)."""
    from hprlp_tpu_torch.ops.device_problem import (attach_tiles,
                                                    build_device_problem)
    from hprlp_tpu_torch.prof.problems import random_lp
    from hprlp_tpu_torch.solver.autotune import set_spmv_backend

    lp, _ = build_device_problem(random_lp(300, 500, 6, seed=1), dtype=F64)
    lp = attach_tiles(lp, build_tiles(lp.A), build_tiles(lp.AT))
    return set_spmv_backend(lp, backend)


@pytest.mark.parametrize("backend", ["tiled", "gather", "dense"])
def test_half_dispatch_on_the_cpu_is_bitwise_the_old_halves(backend):
    """On the CPU x_half / y_half run the plain ops: bitwise the old
    middle iteration (_x_half / _y_half with the Halpern factors of the
    counter advanced t times), the factors made once for both halves."""
    lp = _lp(backend)
    rng = np.random.default_rng(8)
    x, last_x = (torch.as_tensor(rng.normal(size=lp.n)) for _ in range(2))
    y, last_y = (torch.as_tensor(rng.normal(size=lp.m)) for _ in range(2))
    sigma, lam_sigma = torch.tensor(0.37, dtype=F64), torch.tensor(
        1.9, dtype=F64)
    inner = torch.tensor(11, dtype=torch.int32)
    for t in (0, 1, 7):
        counter = inner
        for _ in range(t):
            counter = counter + 1
        f1, f2 = chunk._halpern_factors(counter, F64)
        x_old, xh_old, _, _ = chunk._x_half(lp, x, y, last_x, sigma, f1, f2)
        y_old = chunk._y_half(lp, y, xh_old, last_y, lam_sigma, f1, f2)[0]
        h = chunk.Halpern(inner, t, F64)
        x_new, xh_new = chunk.x_half(lp, x, y, last_x, sigma, h)
        y_new = chunk.y_half(lp, y, xh_new, last_y, lam_sigma, h)
        assert torch.equal(x_new, x_old) and torch.equal(xh_new, xh_old)
        assert torch.equal(y_new, y_old)
        assert "factors" in h.__dict__  # made once, shared by the halves


def test_half_dispatch_fuses_the_tiled_and_gather_backends_on_the_card():
    """The rule: the fused kernel for a matrix on the tiles or on "gather"
    with a CUDA operand; the plain ops for a dense copy or a CPU
    operand."""
    class OnCard:  # stands in for a CUDA tensor: _fused reads its device
        device = torch.device("cuda")

    for backend, fused in (("gather", True), ("tiled", True),
                           ("dense", False)):
        lp = _lp(backend)
        assert chunk._fused(lp.A, OnCard()) is fused
        assert chunk._fused(lp.A, torch.ones(1)) is False
