"""The port's layout, scaling pipeline and power method against the JAX
package on the same layout (CPU, f64)."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import jax
import jax.numpy as jnp
import torch

from hprlp_tpu.ops.device_problem import build_device_problem as jax_build
from hprlp_tpu.ops.sparse import to_coo
from hprlp_tpu.problem import LpProblem as JaxLpProblem
from hprlp_tpu.solver.power_iteration import power_method as jax_power
from hprlp_tpu.solver.scaling import scale_problem as jax_scale
from hprlp_tpu_torch.ops.device_problem import build_device_problem
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.solver.power_iteration import power_method
from hprlp_tpu_torch.solver.scaling import scale_problem

from conftest import random_lp as jax_random_lp

# The tensors here are small: one intra-op thread keeps this test worker
# from competing with the suite's other workers for cores.
torch.set_num_threads(1)

SCALARS = ("b_scale", "c_scale", "norm_b", "norm_c", "norm_b_org",
           "norm_c_org")


def _both(jprob):
    """JAX layout + the port on the same positions and padded sizes."""
    lp_j, maps = jax_build(jprob, dtype=np.float64)
    prob = LpProblem.from_arrays(jprob.A, jprob.AL, jprob.AU, jprob.l,
                                 jprob.u, jprob.c)
    lp_t, maps_t = build_device_problem(
        prob, dtype=torch.float64, device="cpu", row_pos=maps.row_pos,
        col_pos=maps.col_pos, m_pad=lp_j.m, n_pad=lp_j.n)
    return lp_j, lp_t


def _wide_range_lp(seed):
    """Entries spanning 1e-4..1e4 so every scaling pass does real work."""
    rng = np.random.default_rng(seed)
    A = sp.random(50, 70, density=0.2, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)
                  * 10.0 ** rng.uniform(-4, 4, k)).tocsr()
    x = rng.uniform(-1, 1, 70)
    return JaxLpProblem.from_arrays(A, A @ x - 1, np.full(50, np.inf),
                                    x - 1, x + 1, rng.normal(size=70) * 50)


PROBLEMS = {"random_lp0": lambda: jax_random_lp(0),
            "random_lp1": lambda: jax_random_lp(1),
            "wide_range": lambda: _wide_range_lp(5)}


def _coo_dense(M, rows, cols):
    D = np.zeros((rows, cols))
    r, c, v = M
    D[r, c] = v
    return D


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_layout_matches_jax(name):
    lp_j, lp_t = _both(PROBLEMS[name]())
    for mat_j, mat_t in ((lp_j.A, lp_t.A), (lp_j.AT, lp_t.AT)):
        D_j = _coo_dense(to_coo(mat_j), mat_j.nrows, mat_j.ncols)
        D_t = sp.csr_matrix((mat_t.vals.numpy(), mat_t.indices.numpy(),
                             mat_t.indptr.numpy()),
                            shape=(mat_t.nrows, mat_t.ncols)).toarray()
        np.testing.assert_array_equal(D_t, D_j)
    for k in ("AL", "AU", "c", "l", "u"):
        np.testing.assert_array_equal(getattr(lp_t, k).numpy(),
                                      np.asarray(getattr(lp_j, k)))


def test_default_layout_pads_free_rows_and_fixed_columns():
    prob = LpProblem.from_arrays(np.array([[1.0, 2.0], [3.0, 1.0]]),
                                 [-np.inf, 1.0], [10.0, 12.0], [0.0, -1.0],
                                 [np.inf, 4.0], [-3.0, -5.0])
    lp, maps = build_device_problem(prob, dtype=torch.float64)
    assert (lp.m, lp.n) == (32, 32)
    np.testing.assert_array_equal(maps.row_pos, [0, 1])
    assert torch.all(torch.isneginf(lp.AL[2:])) and torch.all(
        torch.isposinf(lp.AU[2:]))
    for v in (lp.c, lp.l, lp.u):
        assert torch.all(v[2:] == 0)
    assert lp.A.nnz == lp.AT.nnz == 4


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_scaling_matches_jax(name):
    lp_j, lp_t = _both(PROBLEMS[name]())
    lps_j, scal_j = jax_scale(lp_j)
    lps_t, scal_t = scale_problem(lp_t)
    for k in ("row_norm", "col_norm"):
        np.testing.assert_allclose(getattr(scal_t, k).numpy(),
                                   np.asarray(getattr(scal_j, k)),
                                   rtol=1e-10)
    for k in SCALARS:
        assert float(getattr(scal_t, k)) == pytest.approx(
            float(getattr(scal_j, k)), rel=1e-10), k
    for k in ("AL", "AU", "c", "l", "u"):
        np.testing.assert_allclose(getattr(lps_t, k).numpy(),
                                   np.asarray(getattr(lps_j, k)), rtol=1e-10,
                                   atol=1e-14)
    D_j = _coo_dense(to_coo(lps_j.A), lp_j.m, lp_j.n)
    D_t = sp.csr_matrix((lps_t.A.vals.numpy(), lps_t.A.indices.numpy(),
                         lps_t.A.indptr.numpy()),
                        shape=(lp_j.m, lp_j.n)).toarray()
    np.testing.assert_allclose(D_t, D_j, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("flags", [(False, True, True, True),
                                   (True, False, True, False),
                                   (True, True, False, True)])
def test_scaling_pass_subsets_match_jax(flags):
    lp_j, lp_t = _both(jax_random_lp(2))
    kw = dict(zip(("use_cr", "use_ruiz", "use_pc", "use_bc"), flags))
    _, scal_j = jax_scale(lp_j, **kw)
    _, scal_t = scale_problem(lp_t, **kw)
    np.testing.assert_allclose(scal_t.row_norm.numpy(),
                               np.asarray(scal_j.row_norm), rtol=1e-10)
    np.testing.assert_allclose(scal_t.col_norm.numpy(),
                               np.asarray(scal_j.col_norm), rtol=1e-10)
    for k in SCALARS:
        assert float(getattr(scal_t, k)) == pytest.approx(
            float(getattr(scal_j, k)), rel=1e-10), k


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_power_method_matches_jax_and_svds(name):
    lp_j, lp_t = _both(PROBLEMS[name]())
    lps_j, _ = jax_scale(lp_j)
    lps_t, _ = scale_problem(lp_t)
    lam_j = float(jax_power(lps_j))
    lam_t = float(power_method(lps_t))
    A = sp.csr_matrix((lps_t.A.vals.numpy(), lps_t.A.indices.numpy(),
                       lps_t.A.indptr.numpy()), shape=(lps_t.m, lps_t.n))
    sigma_max = spla.svds(A, k=1, return_singular_vectors=False,
                          v0=np.ones(min(A.shape)))[0]
    assert lam_t == pytest.approx(sigma_max ** 2, rel=1e-3)
    assert lam_t == pytest.approx(lam_j, rel=1e-3)
    # From JAX's own start vector the two runs are the same iteration.
    z0 = np.array(jax.random.normal(jax.random.PRNGKey(1), (lps_t.m,),
                                      jnp.float64) + 1e-8)
    lam_same = float(power_method(lps_t, z0=torch.as_tensor(z0)))
    assert lam_same == pytest.approx(lam_j, rel=1e-10)
