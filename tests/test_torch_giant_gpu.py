"""The giant regime's ingest on the card: the giant route of solve_problem
bitwise its standard route in f32, on the tiled kernel.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_giant_gpu.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu_torch.ops.spmv import csr_spmv, tiled_spmv
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.solver import loop

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tiled kernel has no CPU mode")
    return torch.device("cuda")


def random_case(seed: int, m: int, n: int, density: float) -> LpProblem:
    """tests/conftest.py::random_lp's LP, built without the JAX package."""
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
    c = rng.normal(size=n)
    return LpProblem.from_arrays(A, AL, AU, l, u, c)


def test_giant_route_is_standard_route_bitwise_on_card(cuda, monkeypatch):
    """tests/test_torch_giant.py's first case on the card, in f32: the same
    iterations, objective and point, on the tiled kernel only."""
    prob = random_case(31, 192, 320, 0.05)
    p = ht.Parameters(verbose=False, stop_tol=1e-4, precision="f32",
                      spmv_backend="lane")
    out = {}
    for route, threshold in (("giant", 100), ("standard", 10**18)):
        monkeypatch.setattr(loop, "GIANT_LANE_FIRST_NNZ", threshold)
        tiled_spmv.launches = csr_spmv.launches = 0
        out[route] = loop.solve_problem(prob, p, device=cuda)
        assert tiled_spmv.launches > 0 and csr_spmv.launches == 0
    rg, rs = out["giant"], out["standard"]
    assert rg.status == rs.status == "OPTIMAL"
    assert rg.iter == rs.iter and rg.primal_obj == rs.primal_obj
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(rg, k), getattr(rs, k))
