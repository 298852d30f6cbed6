"""The port's presolve (hprlp_tpu_torch.presolve over its own build of the
host library) against the JAX package's, on the presolve LPs of
tests/test_native.py.

Exact: the same status, a bitwise-equal reduced problem, the same stats,
and bitwise-equal maps and postsolve of the same reduced vectors.  The
port builds the library with native/Makefile's flags; without
-march=native FMA contraction moves the last bits of the reduced bounds,
which these tests catch."""

import functools
import os
import time

import numpy as np
import pytest
import scipy.sparse as sp

import hprlp_tpu.native as jnative
from hprlp_tpu.presolve import presolve_problem as jax_presolve
from hprlp_tpu.problem import LpProblem as JaxLpProblem
from hprlp_tpu_torch import native
from hprlp_tpu_torch.presolve import presolve_problem, validate_original_kkt
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.prof.problems import structured_lp

from conftest import random_lp as jax_random_lp

INF = np.inf


def _dense(A, AL, AU, l, u, c):
    return sp.csr_matrix(np.asarray(A, float)), AL, AU, l, u, c


def _kitchen_sink(seed):
    """tests/test_native.py::TestReductionCompositions::test_kitchen_sink_lp's
    LP: one-sided slack singletons on equality rows, zero-cost free
    columns, a parallel row."""
    rng = np.random.default_rng(seed)
    m_core, n_core = 14, 18
    A = (sp.random(m_core, n_core, density=0.35, random_state=rng,
                   data_rvs=lambda k: rng.uniform(0.5, 2.0, k))
         + sp.eye(m_core, n_core)).tolil()
    x_feas = rng.uniform(0.0, 1.0, n_core)
    b = A @ x_feas
    AL = list(b.copy())
    AU = list(b.copy())
    kinds = rng.integers(0, 3, m_core)
    for i in range(m_core):
        if kinds[i] == 1:
            AU[i] = INF
        elif kinds[i] == 2:
            AL[i] -= rng.uniform(0.5, 2.0)
            AU[i] += rng.uniform(0.5, 2.0)
    l = list(x_feas - rng.uniform(0.2, 2.0, n_core))
    u = list(x_feas + rng.uniform(0.2, 2.0, n_core))
    c = list(rng.normal(size=n_core))
    A = A.tocsc().tolil()
    extra_cols = []
    for _ in range(3):
        i = int(rng.integers(0, m_core))
        AL[i] = AU[i] = float(b[i])
        col = np.zeros(m_core)
        col[i] = rng.choice([-1.0, 1.5])
        extra_cols.append(col)
        l.append(x_feas.mean() - 50.0)
        u.append(INF)
        c.append(rng.normal())
    for _ in range(2):
        i = int(rng.integers(0, m_core))
        if AL[i] == AU[i]:
            AU[i] = INF
        col = np.zeros(m_core)
        col[i] = 1.0 if np.isinf(AU[i]) else -1.0
        extra_cols.append(col)
        l.append(-INF)
        u.append(INF)
        c.append(0.0)
    A_full = sp.hstack([A.tocsc()] + [sp.csc_matrix(cx.reshape(-1, 1))
                                      for cx in extra_cols]).tocsr()
    dup_of = int(rng.integers(0, m_core))
    A_full = sp.vstack([A_full, A_full[dup_of].multiply(2.0)]).tocsr()
    AL.append(2.0 * AL[dup_of] if np.isfinite(AL[dup_of]) else -INF)
    AU.append(2.0 * AU[dup_of] if np.isfinite(AU[dup_of]) else INF)
    return A_full, AL, AU, l, u, c


def _random(seed, **kw):
    p = jax_random_lp(seed, **kw)
    return p.A, p.AL, p.AU, p.l, p.u, p.c


def _structured(scale):
    p = structured_lp(scale=scale)
    return p.A, p.AL, p.AU, p.l, p.u, p.c


# name -> (arrays, presolve keywords, expected status)
CASES = {
    "singleton_row": (_dense([[1.0, 1.0], [1.0, 0.0]], [-INF, -INF],
                             [10.0, 4.0], [0.0, 0.0], [INF, INF],
                             [-1.0, -1.0]), {}, "OK"),
    "fixed_col": (_dense([[2.0, 1.0]], [-INF], [8.0], [3.0, 0.0],
                         [3.0, INF], [1.0, -1.0]), {}, "OK"),
    "free_singleton_col": (_dense([[1.0, 1.0], [1.0, 0.0]], [2.0, -INF],
                                  [2.0, 5.0], [0.0, -INF], [INF, INF],
                                  [1.0, 2.0]), {}, "OK"),
    "parallel_rows": (_dense([[1.0, 2.0], [2.0, 4.0], [1.0, 0.0]],
                             [-INF, -INF, 0.0], [10.0, 12.0, 4.0],
                             [0.0, 0.0], [INF, INF], [-1.0, -1.0]), {},
                      "OK"),
    "forcing_row": (_dense([[1.0, 1.0]], [2.0], [INF], [0.0, 0.0],
                           [1.0, 1.0], [3.0, 5.0]), {}, "OK"),
    "doubleton_eq": (_dense([[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]], [4.0, -INF],
                            [4.0, 5.0], [0.0, 0.0, 0.0], [INF, INF, INF],
                            [1.0, 2.0, -1.0]), {}, "OK"),
    "parallel_cols": (_dense([[1.0, 2.0, 1.0], [2.0, 4.0, 0.0]],
                             [-INF, -INF], [10.0, 12.0], [0.0, 0.0, 0.0],
                             [4.0, 3.0, INF], [-1.0, -2.0, -5.0]), {},
                      "OK"),
    "eq_to_ineq": (_dense([[1.0, 1.0], [1.0, 0.0]], [2.0, -3.0], [2.0, 3.0],
                          [-INF, 0.0], [INF, INF], [-1.0, 1.0]),
                   {"debug_checks": True}, "OK"),
    "bound_change": (_dense([[1.0, 1.0], [1.0, 0.0]], [-INF, 0.0],
                            [4.0, 1.0], [0.0, -INF], [1.0, INF],
                            [1.0, -1.0]), {"debug_checks": True}, "OK"),
    "fix_col_inf": (_dense([[1.0, -1.0]], [1.0], [INF], [0.0, -INF],
                           [10.0, INF], [1.0, 0.0]),
                    {"debug_checks": True}, "OK"),
    "infeasible": (_dense([[1.0]], [5.0], [INF], [0.0], [2.0], [1.0]), {},
                   "INFEASIBLE"),
    "propagation_infeasible": (_dense([[1.0, 1.0]], [-INF], [1.0],
                                      [1.0, 1.0], [5.0, 5.0], [1.0, 1.0]),
                               {}, "INFEASIBLE"),
    "unbounded": (_dense([[1.0, 0.0]], [-INF], [5.0], [0.0, 0.0],
                         [INF, INF], [1.0, -1.0]), {}, "UNBOUNDED"),
    "unbounded_free_var": (_dense([[1.0, -1.0]], [-1.0], [INF],
                                  [0.0, -INF], [2.0, INF], [0.0, 1.0]),
                           {"debug_checks": True}, "UNBOUNDED"),
    **{f"random_lp{s}": (_random(s, m=25, n=35, density=0.25), {}, "OK")
       for s in range(4)},
    # benchmarks/prof_presolve_scale.py's LP at 1%: without -march=native
    # hundreds of its reduced bounds differ in the last bits.
    "structured_lp_0.01": (_structured(0.01), {}, "OK"),
    # Seed 7's LP is unbounded (its test in test_native.py skips).
    **{f"kitchen_sink{s}": (_kitchen_sink(s), {"debug_checks": True},
                            "UNBOUNDED" if s == 7 else "OK")
       for s in range(8)},
}


# How long a test process waits for another process's build of the JAX
# package's library.
JAX_LIB_WAIT_S = 120.0


@functools.cache
def jax_library():
    """The JAX package's host library, or None.  Its loader runs `make` in
    every test process that finds the library missing, all at once in a
    fresh checkout, and a process whose build lost that race keeps the
    failure for its lifetime.  Such a process waits, once and at most
    JAX_LIB_WAIT_S, for another process's build to land (the Makefile
    renames a finished library into place), then loads it."""
    lib = jnative.get_lib()
    deadline = time.monotonic() + JAX_LIB_WAIT_S
    while lib is None and time.monotonic() < deadline:
        if os.path.exists(jnative._LIB_PATH):
            jnative._lib_error = None
            lib = jnative.get_lib()
            break
        time.sleep(0.5)
    return lib


@pytest.fixture
def libraries():
    """Both packages' host libraries: the port's must build; the JAX
    package's skips where its own loader cannot build it."""
    assert native.is_available(), native.lib_error
    if jax_library() is None:
        pytest.skip(f"hprlp_tpu native library unavailable: "
                    f"{jnative._lib_error}")


def _bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_presolve_matches_jax(case, libraries):
    arrays, kw, want = CASES[case]
    st_t, red_t, h_t = presolve_problem(LpProblem.from_arrays(*arrays), **kw)
    st_j, red_j, h_j = jax_presolve(JaxLpProblem.from_arrays(*arrays), **kw)
    assert st_t == st_j == want
    if want != "OK":
        assert red_t is red_j is None
        return
    for k in ("indptr", "indices", "data"):
        assert _bits(getattr(red_t.A, k)) == _bits(getattr(red_j.A, k)), k
    assert red_t.A.shape == red_j.A.shape
    for k in ("AL", "AU", "l", "u", "c"):
        assert _bits(getattr(red_t, k)) == _bits(getattr(red_j, k)), k
    assert red_t.obj_constant == red_j.obj_constant
    assert h_t.stats() == h_j.stats()
    assert sorted(h_t.report()) == sorted(h_j.report())
    for a, b in zip(h_t.maps(), h_j.maps()):
        assert _bits(a) == _bits(b)
    rng = np.random.default_rng(len(case))
    vecs = (rng.normal(size=red_t.n), rng.normal(size=red_t.m),
            rng.normal(size=red_t.n))
    for a, b in zip(h_t.postsolve(*vecs), h_j.postsolve(*vecs)):
        assert _bits(a) == _bits(b)


def test_library_built_with_the_makefiles_flags():
    """-march=native is what makes the reduced bounds bitwise equal."""
    assert "-march=native" in native.CXXFLAGS
    assert native.get_lib() is not None
    assert native.LIB_PATH.endswith("_build/libhprlp_host.so")


def test_both_libraries_in_one_process(libraries):
    """Both libraries export hpres_*/hpmps_*; each ctypes handle (default
    RTLD_LOCAL) resolves its own."""
    port, jax = native.get_lib(), jnative.get_lib()
    assert port._name != jax._name
    assert port.hpres_presolve_ex is not jax.hpres_presolve_ex
    arrays, kw, _ = CASES["kitchen_sink3"]
    st_t, red_t, _ = presolve_problem(LpProblem.from_arrays(*arrays), **kw)
    st_j, red_j, _ = jax_presolve(JaxLpProblem.from_arrays(*arrays), **kw)
    assert st_t == st_j == "OK"
    assert _bits(red_t.AU) == _bits(red_j.AU)


def test_jax_library_waits_for_a_concurrent_build(monkeypatch):
    """A process whose own build of the JAX package's library failed
    loads the one another process built."""
    assert jax_library() is not None
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_error", "lost the build race")
    jax_library.cache_clear()
    try:
        assert jax_library() is not None
        assert jnative._lib_error is None
    finally:
        jax_library.cache_clear()


def test_validate_original_kkt_warns(capsys):
    arrays, _, _ = CASES["fixed_col"]
    prob = LpProblem.from_arrays(*arrays)
    metrics = validate_original_kkt(prob, np.zeros(2), np.zeros(1),
                                    np.zeros(2), tol=1e-8)
    assert metrics["kkt"] > 1e-7
    assert "original-space KKT" in capsys.readouterr().err
