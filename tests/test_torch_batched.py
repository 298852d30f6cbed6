"""The port's batched shared-A solver (hprlp_tpu_torch/solver/batched.py,
batched_device_loop.py) against the JAX package's, on the CPU in f64: one
chunk from the same state, the per-member decisions, and whole solves on
the cases of tests/test_batched.py; then the port's own rules (frozen
members, host/device reconciliation, options, the dense probe, no
fallback from a failing kernel); the per-member vectors' ingest and
unscale on the device against the NumPy formulas they replaced."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import scipy.sparse as sp
import jax
import jax.numpy as jnp
import torch

from hprlp_tpu import Parameters as JaxParameters
from hprlp_tpu import solve_batched as jax_solve_batched
from hprlp_tpu.ops.device_problem import build_device_problem as jax_build
from hprlp_tpu.ops.sparse import to_coo
from hprlp_tpu.solver import batched as jb
from hprlp_tpu.solver import batched_device_loop as jbl
from hprlp_tpu.solver.scaling import scale_matrix as jax_scale_matrix
import hprlp_tpu_torch as ht
from hprlp_tpu_torch import convert
from hprlp_tpu_torch.ops import sparse
from hprlp_tpu_torch.ops import spmm as spmm_mod
from hprlp_tpu_torch.ops.device_problem import HostMaps, csr_from_coo
from hprlp_tpu_torch.solver import batched as tb
from hprlp_tpu_torch.solver import batched_device_loop as tbl
from hprlp_tpu_torch.solver import device_loop as tloop

from conftest import random_lp as jax_random_lp
from test_torch_batched_gpu import unscale_numpy, vectors_numpy
from test_torch_chunk import SCAL_HOST, _scal_np, random_metrics

# The tensors here are small: one intra-op thread keeps this test worker
# from competing with the suite's other workers for cores.
torch.set_num_threads(1)

F64 = torch.float64
CHECK = 150
B = 5
STATE_VECS = ("x", "y", "last_x", "last_y", "x_bar", "y_bar", "z_bar",
              "y_obj")


def quiet(**kw):
    return ht.Parameters(verbose=False, **kw)


def _close(a, b, rtol, what):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    atol = rtol * max(1.0, float(np.abs(b).max()) if b.size else 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# One chunk from the same point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """JAX's and the port's BatchedLpDevice on the same scaled A, with
    seeded per-member vectors, and a seeded state."""
    lp0, _ = jax_build(jax_random_lp(0), dtype=np.float64)
    A_s, AT_s, rn, cn = jax_scale_matrix(lp0.A, lp0.AT)
    m, n = lp0.m, lp0.n
    rng = np.random.default_rng(5)
    lo = rng.normal(size=(m, B)) - 1.0
    AL = np.where(rng.random((m, B)) < 0.2, -np.inf, lo)
    AU = np.where(rng.random((m, B)) < 0.2, np.inf, lo + rng.uniform(
        0.0, 2.0, (m, B)))
    l = rng.normal(size=(n, B)) - 1.0
    vecs = {"AL": AL, "AU": AU, "c": rng.normal(size=(n, B)), "l": l,
            "u": l + rng.uniform(0.0, 3.0, (n, B))}
    lp_j = jb.BatchedLpDevice(A=A_s, AT=AT_s,
                              **{k: jnp.asarray(v) for k, v in vecs.items()})
    lp_t = tb.BatchedLpDevice(
        A=csr_from_coo(*to_coo(A_s), m, n, F64, "cpu"),
        AT=csr_from_coo(*to_coo(AT_s), n, m, F64, "cpu"),
        **{k: torch.as_tensor(v) for k, v in vecs.items()})
    state = {k: rng.normal(size=((n if k in ("x", "last_x", "x_bar", "z_bar")
                                  else m), B)) for k in STATE_VECS}
    state["inner"] = rng.integers(0, 40, B).astype(np.int32)
    norms = (np.array(rn), np.array(cn))
    return lp_j, lp_t, norms, state


def _states(state):
    sj = jb.BatchedState(**{k: jnp.asarray(v) for k, v in state.items()})
    st = tb.BatchedState(**{k: torch.as_tensor(v) for k, v in state.items()})
    return sj, st


@pytest.mark.parametrize("n_iters", [2, 20])
def test_run_batched_chunk_matches_jax(pair, n_iters):
    """Mixed restart flags and active mask, f64: state and metrics to
    1e-12 (ELL buckets and CSR rows sum in another order)."""
    lp_j, lp_t, (rn, cn), state = pair
    sigma = np.array([0.7, 1.3, 0.2, 4.0, 1.0])
    lam = np.full(B, 3.1)
    flag = np.array([True, False, True, False, False])
    active = np.array([True, True, False, True, False])
    sj, st = _states(state)
    out_j = jb.run_batched_chunk(
        lp_j, jnp.asarray(rn), jnp.asarray(cn), sj, jnp.asarray(sigma),
        jnp.asarray(lam), jnp.asarray(flag), jnp.asarray(active),
        jnp.asarray(n_iters, jnp.int32))
    out_t = tb.run_batched_chunk(
        lp_t, torch.as_tensor(rn), torch.as_tensor(cn), st,
        torch.as_tensor(sigma), torch.as_tensor(lam), torch.as_tensor(flag),
        torch.as_tensor(active), n_iters)
    (st_j, m_j), (st_t, m_t) = out_j, out_t
    assert set(m_t) == set(m_j)
    for k in m_j:
        _close(m_t[k].numpy(), m_j[k], 1e-12, k)
    for k in STATE_VECS:
        _close(getattr(st_t, k).numpy(), getattr(st_j, k), 1e-12, k)
    np.testing.assert_array_equal(st_t.inner.numpy(), np.asarray(st_j.inner))


def test_frozen_members_keep_their_state_bit_for_bit(pair):
    """Members 2 and 4 are inactive through three superchunk chunks: every
    carried tensor keeps their columns bit for bit, and their Halpern
    counters stand still."""
    _, lp_t, (rn, cn), state = pair
    _, st = _states(state)
    rn_t, cn_t = torch.as_tensor(rn), torch.as_tensor(cn)
    active = torch.tensor([True, True, False, True, False])
    sigma = torch.full((B,), 0.9, dtype=F64)
    lam = torch.full((B,), 3.1, dtype=F64)
    m0 = tb.initial_bmetrics(lp_t, rn_t, cn_t, st)
    ones = torch.ones(B, dtype=F64)
    out = tbl.run_batched_superchunk(
        lp_t, rn_t, cn_t, st, tbl.init_batched_restart_dev(sigma, F64),
        sigma, lam, active, m0, 0, ones, ones, ones, ones, ones * 0.0, 0.0,
        3, 10)
    st_new, stacked, k_done = out[0], out[6], out[7]
    assert k_done == 3
    for k in STATE_VECS:
        before, after = getattr(st, k), getattr(st_new, k)
        for j in (2, 4):
            assert torch.equal(after[:, j], before[:, j]), (k, j)
        assert not torch.equal(after[:, 0], before[:, 0]) or k in (
            "last_x", "last_y"), k
    np.testing.assert_array_equal(st_new.inner[[2, 4]], st.inner[[2, 4]])
    np.testing.assert_array_equal(stacked["active"][:, [2, 4]], 0.0)
    np.testing.assert_array_equal(stacked["active_after"][:, [2, 4]], 0.0)


# ---------------------------------------------------------------------------
# Decisions, in the style of tests/test_device_loop_oracle.py::
# test_batched_decide_matches_single_memberwise
# ---------------------------------------------------------------------------

_jax_bdecide = jax.jit(jbl._bdecide, static_argnames=("check_iter", "dtype"))
_jax_m_norm = jax.jit(jbl._m_norm_dev)


def test_bdecide_matches_jax_and_single_memberwise():
    """40 boundaries of random metrics for 5 members: the port's _bdecide
    against JAX's (flag exact; sigma and lambda to 1e-6, since sigma's
    f32 exp/log chain may differ in the last bit between XLA and PyTorch,
    as in tests/test_torch_chunk.py) and, member by member, against the
    port's single-LP _decide_and_update (flag exact, sigma and lambda to
    1e-12) with the batched path's post-chunk bookkeeping."""
    rngs = [np.random.default_rng(100 + i) for i in range(B)]
    tiny = [False, True, False, True, False]
    obj_c = np.linspace(-0.5, 0.5, B)
    sigma0 = np.array([float(r.lognormal(0, 0.5)) for r in rngs])
    lam0 = np.array([float(r.lognormal(1, 0.5)) for r in rngs])
    vec = {k: np.full(B, SCAL_HOST[k]) for k in SCAL_HOST}
    active = np.ones(B, bool)

    rd_j = jbl.init_batched_restart_dev(jnp.asarray(sigma0), jnp.float64)
    sig_j, lam_j = jnp.asarray(sigma0), jnp.asarray(lam0)
    rd_t = tbl.init_batched_restart_dev(torch.as_tensor(sigma0), F64)
    sig_t, lam_t = torch.as_tensor(sigma0), torch.as_tensor(lam0)
    scal_t = convert.scaling_from_numpy(_scal_np())
    rds = [tloop.init_restart_dev(sigma0[i], F64, "cpu") for i in range(B)]
    sigs = [torch.tensor(sigma0[i], dtype=F64) for i in range(B)]
    lams = [torch.tensor(lam0[i], dtype=F64) for i in range(B)]

    metrics = [random_metrics(rngs[i], 1.0, tiny[i]) for i in range(B)]
    it = 0
    for step in range(40):
        m_b = {k: np.array([metrics[i][k] for i in range(B)])
               for k in metrics[0]}
        rd_j, sig_j, lam_j, flag_j, _ = _jax_bdecide(
            rd_j, sig_j, lam_j, jnp.asarray(active),
            {k: jnp.asarray(v) for k, v in m_b.items()},
            *(jnp.asarray(vec[k]) for k in ("b_scale", "c_scale",
                                            "norm_b_org", "norm_c_org")),
            jnp.asarray(obj_c), it, check_iter=CHECK, dtype=jnp.float64)
        rd_t, sig_t, lam_t, flag_t, _ = tbl._bdecide(
            rd_t, sig_t, lam_t, torch.as_tensor(active),
            {k: torch.as_tensor(v) for k, v in m_b.items()},
            *(torch.as_tensor(vec[k]) for k in ("b_scale", "c_scale",
                                                "norm_b_org", "norm_c_org")),
            torch.as_tensor(obj_c), it, CHECK, F64)
        np.testing.assert_array_equal(flag_t.numpy(), np.asarray(flag_j),
                                      err_msg=f"step {step}")
        _close(sig_t.numpy(), sig_j, 1e-6, f"step {step}: sigma")
        _close(lam_t.numpy(), lam_j, 1e-6, f"step {step}: lambda")

        scale = math.exp(-0.05 * step)
        m_next = [random_metrics(rngs[i], scale, tiny[i]) for i in range(B)]
        fs = {k: np.array([m_next[i][k] for i in range(B)])
              for k in ("fs_dot", "fs_dy2", "fs_dx2")}
        # Post-chunk bookkeeping exactly as run_batched_superchunk does.
        lg_j, fix_j = _jax_m_norm(sig_j, lam_j, *(jnp.asarray(fs[k])
                                                  for k in fs))
        lam_j = jnp.where(flag_j, fix_j, lam_j)
        rd_j = dataclasses.replace(
            rd_j, last_gap=jnp.where(flag_j, lg_j, rd_j.last_gap),
            inner=rd_j.inner + float(CHECK))
        lg_t, fix_t = tloop._m_norm_dev(sig_t, lam_t, *(torch.as_tensor(
            fs[k]) for k in fs))
        lam_t = torch.where(flag_t, fix_t, lam_t)
        rd_t = dataclasses.replace(
            rd_t, last_gap=torch.where(flag_t, lg_t, rd_t.last_gap),
            inner=rd_t.inner + float(CHECK))

        for i in range(B):
            m_i = {k: torch.tensor(v, dtype=F64)
                   for k, v in metrics[i].items()}
            rds[i], sigs[i], lams[i], flag_i = tloop._decide_and_update(
                rds[i], sigs[i], lams[i], m_i, scal_t,
                torch.tensor(obj_c[i], dtype=F64), it, CHECK, F64)
            assert bool(flag_t[i]) == bool(flag_i), f"step {step} member {i}"
            assert float(sig_t[i]) == pytest.approx(float(sigs[i]),
                                                    rel=1e-12), (step, i)
            lg_i, fix_i = tloop._m_norm_dev(
                sigs[i], lams[i], *(torch.tensor(m_next[i][k], dtype=F64)
                                    for k in fs))
            if bool(flag_i):
                lams[i] = fix_i
                rds[i] = dataclasses.replace(rds[i], last_gap=lg_i)
            rds[i] = dataclasses.replace(rds[i], inner=rds[i].inner + CHECK)
            assert float(lam_t[i]) == pytest.approx(float(lams[i]),
                                                    rel=1e-12), (step, i)
        np.testing.assert_array_equal(rd_t.times.numpy(),
                                      np.asarray(rd_j.times))
        np.testing.assert_array_equal(rd_t.first_restart.numpy(),
                                      np.asarray(rd_j.first_restart))
        metrics = m_next
        it += CHECK


def test_first_restart_clears_for_every_member_together():
    """clear_fr = any(fr): one member's first restart clears the flag of
    all, the inactive ones included (the reference's rule)."""
    sigma = torch.ones(3, dtype=F64)
    rd = tbl.init_batched_restart_dev(sigma, F64)
    m = {k: torch.ones(3, dtype=F64) for k in tloop.METRIC_KEYS}
    one = torch.ones(3, dtype=F64)
    rd, _, _, flag, _ = tbl._bdecide(
        rd, sigma, sigma, torch.tensor([True, False, False]), m, one, one,
        one, one, one * 0.0, CHECK, CHECK, F64)
    assert flag.tolist() == [True, False, False]
    assert rd.first_restart.tolist() == [False, False, False]


# ---------------------------------------------------------------------------
# Whole solves against JAX: the cases of tests/test_batched.py
# ---------------------------------------------------------------------------

def _demo():
    A = np.array([[1.0, 2.0], [3.0, 1.0]])
    C = np.outer([-3.0, -5.0], np.arange(1, 5, dtype=float))
    return (A, C, np.full((2, 4), -np.inf), np.tile([[10.0], [12.0]], (1, 4)),
            np.zeros((2, 4)), np.full((2, 4), np.inf)), {}, None


def _linprog_random():
    rng = np.random.default_rng(7)
    m, n, b = 12, 18, 5
    A = sp.random(m, n, density=0.4, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    C = rng.normal(size=(n, b))
    x0 = rng.uniform(-1, 1, size=(n, b))
    Ax = A @ x0
    AL = Ax - rng.uniform(0.2, 1.5, size=(m, b))
    AU = Ax + rng.uniform(0.2, 1.5, size=(m, b))
    l = x0 - rng.uniform(0.5, 2.0, size=(n, b))
    u = x0 + rng.uniform(0.5, 2.0, size=(n, b))
    return (A, C, AL, AU, l, u), {"stop_tol": 1e-6}, None


def _obj_constants():
    return ((np.array([[1.0]]), np.array([[1.0, 1.0]]),
             np.array([[0.0, 0.0]]), np.array([[np.inf, np.inf]]),
             np.array([[2.0, 3.0]]), np.array([[np.inf, np.inf]])), {},
            np.array([10.0, -10.0]))


def _iter_limit():
    rng = np.random.default_rng(3)
    m, n, b = 8, 10, 2
    A = sp.random(m, n, density=0.5, random_state=rng).tocsr()
    x0 = rng.uniform(-1, 1, size=(n, b))
    Ax = A @ x0
    return ((A, rng.normal(size=(n, b)), Ax - 0.5, Ax + 0.5, x0 - 1, x0 + 1),
            {"max_iter": 4, "stop_tol": 1e-14}, None)


CASES = {"demo": _demo, "linprog_random": _linprog_random,
         "obj_constants": _obj_constants, "iter_limit": _iter_limit}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_batched_matches_jax(case):
    """Statuses and per-member iteration counts equal; objectives to 1e-6
    relative and x, y, z to 1e-6 (the lambda of the two power methods,
    from different random starts, agrees to ~1e-8)."""
    args, kw, oc = CASES[case]()
    rj = jax_solve_batched(*args, obj_constants=oc,
                           params=JaxParameters(verbose=False, **kw))
    rt = ht.solve_batched(*args, obj_constants=oc, params=quiet(**kw),
                          device="cpu")
    assert isinstance(rt, ht.BatchedResults)
    assert (rt.m, rt.n, rt.batch_size) == (rj.m, rj.n, rj.batch_size)
    assert rt.status == rj.status
    np.testing.assert_array_equal(rt.iter, rj.iter)
    np.testing.assert_allclose(rt.primal_obj, rj.primal_obj, rtol=1e-6,
                               atol=1e-6)
    for k in ("x", "y", "z"):
        got, want = getattr(rt, k), getattr(rj, k)
        assert got.shape == want.shape and got.flags.f_contiguous, k
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert rt.time == pytest.approx(rt.setup_time + rt.solve_time)
    assert min(rt.setup_time, rt.power_time, rt.solve_time) > 0.0
    if case == "demo":
        np.testing.assert_allclose(rt.primal_obj,
                                   -26.4 * np.arange(1, 5), rtol=1e-2)
    if case == "iter_limit":
        assert "ITER_LIMIT" in rt.status


@pytest.mark.parametrize("bad", ["shape", "bounds", "ndim"])
def test_validation_raises_as_in_jax(bad):
    A = np.eye(2)
    args = {"shape": (A, np.zeros((2, 3)), np.zeros((2, 2)), np.zeros((2, 3)),
                      np.zeros((2, 3)), np.zeros((2, 3))),
            "bounds": (A, np.ones((2, 2)), np.ones((2, 2)), -np.ones((2, 2)),
                       np.zeros((2, 2)), np.ones((2, 2))),
            "ndim": (A, np.zeros(2), np.zeros((2, 1)), np.zeros((2, 1)),
                     np.zeros((2, 1)), np.zeros((2, 1)))}[bad]
    with pytest.raises(ValueError) as ej:
        jax_solve_batched(*args, params=JaxParameters(verbose=False))
    with pytest.raises(ValueError) as et:
        ht.solve_batched(*args, params=quiet(), device="cpu")
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# The port's own rules
# ---------------------------------------------------------------------------

def test_device_freeze_is_authoritative(monkeypatch):
    """A member the device froze while the host's f64 KKT says it is not
    converged ends OPTIMAL at once, and the loop does not wedge.  Verbose
    solves run one chunk per call, so the first call ends at 150."""
    args, kw, _ = _linprog_random()
    base = ht.solve_batched(*args, params=quiet(**kw), device="cpu")
    real = tbl.run_batched_superchunk
    calls = []

    def device_freezes_member_0(*a):
        out = list(real(*a))
        if not calls:
            out[4] = out[4].clone()
            out[4][0] = False
            out[6]["active_after"][-1, 0] = 0.0
        calls.append(out[7])
        return tuple(out)

    monkeypatch.setattr(tbl, "run_batched_superchunk",
                        device_freezes_member_0)
    out = ht.solve_batched(*args, params=ht.Parameters(**kw), device="cpu")
    assert calls[0] == 1
    assert out.status == ["OPTIMAL"] * 5
    assert out.iter[0] == 150 < base.iter[0]
    np.testing.assert_array_equal(out.iter[1:], base.iter[1:])


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, _, _ = _demo()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ht.solve_batched(*args, params=quiet())


def test_mesh_batch_not_divisible_raises_as_jax():
    """mesh_shape shards the batch axis: a batch of 4 on a mesh of 3 (JAX:
    of 8 devices) raises ValueError in both packages, before any rank
    starts."""
    args, _, _ = _demo()
    assert args[1].shape[1] == 4
    with pytest.raises(ValueError, match="not divisible"):
        ht.solve_batched(*args, params=quiet(mesh_shape=3), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        jax_solve_batched(*args, params=JaxParameters(verbose=False,
                                                      mesh_shape=8))


@pytest.mark.parametrize("backend", ["gather", "lane", "dense"])
def test_backends_give_the_same_solve(backend, capsys, monkeypatch):
    """"gather" and "lane" run the SpMM's plain version here (the kernel on
    the card), "lane" after the JAX package's notice; "dense" runs only
    the dense product.  No probe runs on the CPU."""
    args, kw, _ = _linprog_random()
    ref = ht.solve_batched(*args, params=quiet(**kw), device="cpu")
    if backend == "dense":
        monkeypatch.setattr(sparse, "spmm_reference", None)
    out = ht.solve_batched(*args, params=quiet(spmv_backend=backend, **kw),
                           device="cpu")
    assert ht.solve_batched.probe is None
    err = capsys.readouterr().err
    assert ("no lane SpMM lowering" in err) == (backend == "lane")
    assert out.status == ref.status
    np.testing.assert_array_equal(out.iter, ref.iter)
    np.testing.assert_allclose(out.x, ref.x, rtol=1e-9, atol=1e-9)


def _probe_inputs():
    args, _, _ = _linprog_random()
    A, C, AL, AU, l, u = args
    prob = ht.LpProblem.from_arrays(A, AL[:, 0], AU[:, 0], l[:, 0], u[:, 0],
                                    C[:, 0])
    from hprlp_tpu_torch.ops.device_problem import build_device_problem

    lp0, _ = build_device_problem(prob, dtype=F64, device="cpu")
    m, n = lp0.m, lp0.n
    z = torch.zeros
    lp = tb.BatchedLpDevice(A=lp0.A, AT=lp0.AT, AL=z(m, 5, dtype=F64) - 1,
                            AU=z(m, 5, dtype=F64) + 1, c=z(n, 5, dtype=F64)
                            + 1, l=z(n, 5, dtype=F64) - 1,
                            u=z(n, 5, dtype=F64) + 1)
    ones_m, ones_n = torch.ones(m, dtype=F64), torch.ones(n, dtype=F64)
    st = tb.init_batched_state(lp)
    return lp, ones_m, ones_n, st, torch.ones(5, dtype=F64)


def test_dense_probe_times_both_and_keeps_merit():
    lp, rn, cn, st, one = _probe_inputs()
    got, rec = tb._probe_dense(lp, rn, cn, st, one, one * 4.0,
                               lambda *a: None)
    assert rec["kernel_ms"] > 0.0 and rec["dense_ms"] > 0.0
    assert rec["merit_ok"] is True
    assert rec["backend"] == ("dense" if got.A.dense is not None
                              else "gather")
    assert (got.A.dense is None) == (got.AT.dense is None)


def test_dense_probe_out_of_memory_keeps_the_kernel(monkeypatch, capsys):
    def oom(A, backend):
        raise torch.cuda.OutOfMemoryError("stand-in")

    monkeypatch.setattr(tb, "with_backend", oom)
    lp, rn, cn, st, one = _probe_inputs()
    got, rec = tb._probe_dense(lp, rn, cn, st, one, one * 4.0,
                               lambda *a: None)
    assert got is lp and rec["backend"] == "gather"
    assert rec["dense_ms"] is None
    assert "out of device memory" in capsys.readouterr().err


def test_failing_kernel_raises_through_the_solve(monkeypatch):
    """The SpMM routed through the kernel's wrapper, whose build fails:
    the solve raises and nothing falls back to the plain version."""
    def no_build(source=None, ptxas_log=None):
        raise RuntimeError("nvcc failed (1): stand-in")

    monkeypatch.setattr(spmm_mod, "build", no_build)
    monkeypatch.setattr(spmm_mod, "check_spmm_args", lambda A, X: None)
    monkeypatch.setattr(sparse, "spmm_reference", spmm_mod.csr_spmm)
    spmm_mod._library.cache_clear()
    args, _, _ = _demo()
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ht.solve_batched(*args, params=quiet(), device="cpu")
    finally:
        spmm_mod._library.cache_clear()


# ---------------------------------------------------------------------------
# The middle iteration's halves (fused on the card, plain here)
# ---------------------------------------------------------------------------

ACTIVE = np.array([True, False, True, True, False])


@pytest.mark.parametrize("t", [0, 7])
def test_plain_halves_match_jax_halves_and_freeze(pair, t):
    """x_half_plain / y_half_plain against JAX's _bx_half / _by_half and
    the freeze of its fori_loop body (hprlp_tpu/solver/batched.py:162-168),
    with the Halpern counters advanced by t for active members, f64, to
    1e-12; frozen members keep x and y bit for bit."""
    lp_j, lp_t, _, state = pair
    sigma = np.array([0.7, 1.3, 0.2, 4.0, 1.0])
    lam_sigma = 3.1 * sigma
    inner = state["inner"]
    f1, f2 = jb._bfactors(jnp.asarray(np.where(ACTIVE, inner + t, inner)),
                          jnp.float64)
    x_new, x_hat, _, _ = jb._bx_half(
        lp_j, *(jnp.asarray(state[k]) for k in ("x", "y", "last_x")),
        jnp.asarray(sigma)[None, :], f1, f2)
    y_new, _, _ = jb._by_half(lp_j, jnp.asarray(state["y"]), x_hat,
                              jnp.asarray(state["last_y"]),
                              jnp.asarray(lam_sigma)[None, :], f1, f2)
    keep = ACTIVE[None, :]
    want_x = np.where(keep, np.asarray(x_new), state["x"])
    want_y = np.where(keep, np.asarray(y_new), state["y"])

    tt = {k: torch.as_tensor(v) for k, v in state.items()}
    active = torch.as_tensor(ACTIVE)
    got_x, got_hat = tb.x_half_plain(
        lp_t, tt["x"], tt["y"], tt["last_x"],
        torch.as_tensor(sigma)[None, :], tt["inner"], t, active)
    got_y = tb.y_half_plain(lp_t, tt["y"], got_hat, tt["last_y"],
                            torch.as_tensor(lam_sigma)[None, :], tt["inner"],
                            t, active)
    _close(got_hat.numpy(), np.asarray(x_hat), 1e-12, "x_hat")
    _close(got_x.numpy(), want_x, 1e-12, "x")
    _close(got_y.numpy(), want_y, 1e-12, "y")
    for got, old in ((got_x, tt["x"]), (got_y, tt["y"])):
        assert torch.equal(got[:, ~active], old[:, ~active])


def test_halves_dispatch_to_the_plain_version_on_the_cpu(pair, monkeypatch):
    """A CPU tensor goes to the plain halves, bitwise; a dense copy too,
    whatever the device; the fused kernels' wrappers are never called."""
    def no_kernel(*a, **k):
        raise AssertionError("the fused kernel was called on the CPU")

    monkeypatch.setattr(tb, "spmm_x_half", no_kernel)
    monkeypatch.setattr(tb, "spmm_y_half", no_kernel)
    _, lp_t, _, state = pair
    tt = {k: torch.as_tensor(v) for k, v in state.items()}
    sigma = torch.full((1, B), 0.9, dtype=F64)
    active = torch.as_tensor(ACTIVE)
    dense = dataclasses.replace(lp_t, A=sparse.with_backend(lp_t.A, "dense"),
                                AT=sparse.with_backend(lp_t.AT, "dense"))
    for lp in (lp_t, dense):
        xs = tb.x_half(lp, tt["x"], tt["y"], tt["last_x"], sigma,
                       tt["inner"], 3, active)
        want = tb.x_half_plain(lp_t, tt["x"], tt["y"], tt["last_x"], sigma,
                               tt["inner"], 3, active)
        for got, ref in zip(xs, want):
            _close(got.numpy(), ref.numpy(), 1e-13, "x")
        ys = tb.y_half(lp, tt["y"], xs[1], tt["last_y"], sigma * 3.0,
                       tt["inner"], 3, active)
        _close(ys.numpy(), tb.y_half_plain(
            lp_t, tt["y"], xs[1], tt["last_y"], sigma * 3.0, tt["inner"], 3,
            active).numpy(), 1e-13, "y")
    assert torch.equal(tb.x_half(lp_t, tt["x"], tt["y"], tt["last_x"], sigma,
                                 tt["inner"], 3, active)[0],
                       tb.x_half_plain(lp_t, tt["x"], tt["y"], tt["last_x"],
                                       sigma, tt["inner"], 3, active)[0])
    with pytest.raises(ValueError, match="unsupported device"):
        tb.x_half(lp_t, tt["x"].to("meta"), tt["y"], tt["last_x"], sigma,
                  tt["inner"], 3, active)


def test_failing_fused_kernel_raises_and_does_not_fall_back(pair,
                                                            monkeypatch):
    """Where the halves go to the fused kernel (the device check stood in
    for here), a kernel that does not build raises from run_batched_chunk;
    the plain halves are never run in its place."""
    def no_build(source=None, ptxas_log=None):
        raise RuntimeError("nvcc failed (1): stand-in")

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain halves")

    monkeypatch.setattr(spmm_mod, "build", no_build)
    monkeypatch.setattr(spmm_mod, "check_half_args", lambda *a: None)
    monkeypatch.setattr(tb, "_fused", lambda M, v: True)
    monkeypatch.setattr(tb, "x_half_plain", no_plain)
    monkeypatch.setattr(tb, "y_half_plain", no_plain)
    spmm_mod._library.cache_clear()
    _, lp_t, (rn, cn), state = pair
    _, st = _states(state)
    one = torch.ones(B, dtype=F64)
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            tb.run_batched_chunk(lp_t, torch.as_tensor(rn),
                                 torch.as_tensor(cn), st, one, one * 3.0,
                                 torch.zeros(B, dtype=torch.bool),
                                 torch.as_tensor(ACTIVE), 5)
    finally:
        spmm_mod._library.cache_clear()


# ---------------------------------------------------------------------------
# The per-member vectors on the device: ingest and unscale
# ---------------------------------------------------------------------------

def _member_vectors(rng, m, n, B):
    """Seeded (n, B) C, l, u and (m, B) AL, AU with infinite bounds in
    places."""
    AL = np.where(rng.random((m, B)) < 0.2, -np.inf, rng.normal(size=(m, B)))
    AU = np.where(rng.random((m, B)) < 0.2, np.inf,
                  np.maximum(AL, 0.0) + rng.uniform(0.0, 2.0, (m, B)))
    l = np.where(rng.random((n, B)) < 0.2, -np.inf, rng.normal(size=(n, B)))
    u = np.where(rng.random((n, B)) < 0.2, np.inf,
                 np.maximum(l, 0.0) + rng.uniform(0.0, 3.0, (n, B)))
    return rng.normal(size=(n, B)) * 10.0, AL, AU, l, u


@pytest.mark.parametrize("bc, dtype", [(True, F64), (False, F64),
                                       (False, torch.float32)])
def test_setup_batched_vectors_match_numpy(bc, dtype):
    """setup_batched's padded scaled vectors and norms against the host
    formula they replaced, on the same matrix norms: 45 x 70 padded to 64
    x 96; exact where no norm enters, else within 1e-14; the infinities
    in place; the norms NumPy (B,) float64."""
    rng = np.random.default_rng(11)
    m, n, Bm = 45, 70, 4
    A = sp.random(m, n, density=0.2, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k) * 5.0).tocsr()
    vecs = _member_vectors(rng, m, n, Bm)
    su = tb.setup_batched(A, *vecs, quiet(use_bc_scaling=bc),
                          torch.device("cpu"), dtype)
    assert (su.lp0.m, su.lp0.n) == (64, 96)
    want, norms = vectors_numpy(
        *vecs, su.row_norm.numpy().astype(np.float64),
        su.col_norm.numpy().astype(np.float64), su.maps, 64, 96, bc)
    for name, ref in want.items():
        got = getattr(su.lp, name)
        assert got.dtype == dtype, name
        got = got.numpy()
        ref = ref.astype(got.dtype)
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref), name)
        np.testing.assert_array_equal(got[np.isinf(got)],
                                      ref[np.isinf(ref)], name)
        if bc:
            np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0.0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, ref, name)
    assert np.isneginf(su.lp.AL.numpy()[m:]).all()
    assert np.isposinf(su.lp.AU.numpy()[m:]).all()
    for name, ref in norms.items():
        got = getattr(su, name)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        assert got.shape == (Bm,), name
        np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0.0,
                                   err_msg=name)
    if not bc:
        assert (su.b_scale == 1.0).all() and (su.c_scale == 1.0).all()
    np.testing.assert_allclose(
        tb.initial_sigma(su),
        tb.initial_sigma(dataclasses.replace(su, **norms)), rtol=1e-14,
        atol=0.0)


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_unscale_solution_is_numpys_bitwise(permuted, dtype):
    """x, y, z from a random state bitwise the host unscale they replaced:
    45 x 70 in a 64 x 96 padded space, at the first positions or at
    scattered ones, b_scale and c_scale away from 1; float64, (rows, B),
    F-contiguous."""
    rng = np.random.default_rng(3 + permuted)
    m, n, m_pad, n_pad, Bm = 45, 70, 64, 96, 4
    if permuted:
        row_pos = rng.permutation(m_pad)[:m]
        col_pos = rng.permutation(n_pad)[:n]
    else:
        row_pos, col_pos = np.arange(m), np.arange(n)
    maps = HostMaps(row_pos=row_pos, col_pos=col_pos, m_orig=m, n_orig=n,
                    obj_constant=0.0, objective_sense=1)
    rows = {"x": n_pad, "last_x": n_pad, "x_bar": n_pad, "z_bar": n_pad,
            "y": m_pad, "last_y": m_pad, "y_bar": m_pad, "y_obj": m_pad}
    state = tb.BatchedState(
        **{k: torch.as_tensor(rng.normal(size=(r, Bm)) * 100.0).to(dtype)
           for k, r in rows.items()},
        inner=torch.zeros(Bm, dtype=torch.int32))
    b_scale, c_scale = rng.uniform(1.5, 40.0, (2, Bm))
    row_norm = torch.as_tensor(np.exp(rng.normal(size=m_pad))).to(dtype)
    col_norm = torch.as_tensor(np.exp(rng.normal(size=n_pad))).to(dtype)
    *got, d2h = tb.unscale_solution(state, b_scale, c_scale, row_norm,
                                    col_norm, maps)
    want = unscale_numpy(state.x_bar.numpy(), state.y_bar.numpy(),
                         state.z_bar.numpy(), b_scale, c_scale,
                         row_norm.numpy(), col_norm.numpy(), maps)
    for v, ref, r in zip(got, want, (n, m, n)):
        assert v.dtype == np.float64 and v.shape == (r, Bm)
        assert v.flags.f_contiguous
        np.testing.assert_array_equal(v, ref)
    assert d2h == 8 * Bm * (2 * n + m)
