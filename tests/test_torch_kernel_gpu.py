"""The CUDA SpMV kernels and the port's main path on the card.

Every test here needs a CUDA device (the kernel has no CPU mode) and skips
without one.  The file imports neither JAX nor the JAX package, so that it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_kernel_gpu.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.sparse import spmv, with_spmv_backend
from hprlp_tpu_torch.ops.spmv import (csr_spmv, csr_spmv_rowgroup,
                                      spmv_reference, tiled_spmv)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mean_row", [1, 3, 7, 12, 40])
def test_kernel_matches_plain(cuda, mean_row):
    """The "gather" backend's CSR kernel (csrc/spmv_csr.cu, through spmv)
    and the previous row-group kernel at every threads-per-row width
    (2..32, from the mean row length), f32 and f64, against the plain
    version on the same card; one launch per call.  Tolerances: the
    summation order differs."""
    rng = np.random.default_rng(mean_row)
    A = sp.random(3000, 5000, density=mean_row / 5000, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocoo()
    x = rng.normal(size=5000)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        M = with_spmv_backend(csr_from_coo(A.row, A.col, A.data, 3000, 5000,
                                           dtype, cuda), "gather")
        xd = torch.as_tensor(x, device=cuda).to(dtype)
        before = (csr_spmv.launches, csr_spmv_rowgroup.launches)
        y = spmv(M, xd)
        y_prev = csr_spmv_rowgroup(M, xd)
        torch.cuda.synchronize()
        assert (csr_spmv.launches, csr_spmv_rowgroup.launches) == (
            before[0] + 1, before[1] + 1)
        y_ref = spmv_reference(M, xd)
        scale = max(1.0, float(y_ref.abs().max()))
        assert float((y - y_ref).abs().max()) <= tol * scale
        assert float((y_prev - y_ref).abs().max()) <= tol * scale


def test_kernel_rejects_bad_arguments(cuda):
    M = csr_from_coo([0], [0], [1.0], 4, 4, torch.float32, cuda)
    with pytest.raises(TypeError):
        csr_spmv(M, torch.ones(4, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        csr_spmv(M, torch.ones(5, device=cuda))


def test_solve_on_the_card_goes_through_the_kernel(cuda):
    """The solve's SpMVs run on the tiled kernel (csrc/spmv_tiled.cu),
    which succeeded this CSR kernel on the main path."""
    tiled_spmv.launches = 0
    res = ht.solve(np.array([[1.0, 2.0], [3.0, 1.0]]), [-np.inf] * 2,
                   [10.0, 12.0], [0.0, 0.0], [np.inf] * 2, [-3.0, -5.0],
                   ht.Parameters(verbose=False, use_presolve=False))
    assert res.status == "OPTIMAL"
    assert res.primal_obj == pytest.approx(-26.4, abs=1e-2)
    assert tiled_spmv.launches > 0
