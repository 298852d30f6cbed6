"""Two repairs of the port, on the CPU.

* The native MPS reader tells gzip by a ".gz" suffix alone before it picks
  memory mode; io/native_mps.py sniffs gzip's magic and keeps such a file
  on the stream reader, without touching native/.
* On the card, ops/sparse.py's row sums run on the SpMM kernel against a
  column of ones (CSR order, bitwise repeatable) in place of
  scatter_reduce_'s atomics; the device check is stood in for here, and
  the kernel by its plain version.  Tests/test_torch_batched_gpu.py checks
  the kernel route on the card.
"""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from hprlp_tpu_torch import native
from hprlp_tpu_torch.io import native_mps
from hprlp_tpu_torch.io.mps import read_mps
from hprlp_tpu_torch.io.native_mps import MEMORY_MODE_ENV, read_mps_native
from hprlp_tpu_torch.ops import sparse
from hprlp_tpu_torch.ops.device_problem import csr_from_coo
from hprlp_tpu_torch.ops.spmm import spmm_reference
from hprlp_tpu_torch.ops.spmv import row_of_entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "data", "model.mps")


@pytest.fixture
def host_library():
    assert native.is_available(), native.lib_error


def _same_problem(a, b):
    for k in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a.A, k), getattr(b.A, k))
    for k in ("AL", "AU", "l", "u", "c"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.obj_constant == b.obj_constant


@pytest.mark.parametrize("name", ["model.mps", "model", "model.mps.gz"])
def test_gzip_under_any_name_reads_as_the_python_reader(tmp_path, name,
                                                        monkeypatch,
                                                        host_library):
    """A gzip MPS file, read with memory mode on for every size: the
    native reader returns what io/mps.py returns, and the threshold is the
    caller's again after the call."""
    path = str(tmp_path / name)
    with open(MODEL, "rb") as src, gzip.open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    monkeypatch.setenv(MEMORY_MODE_ENV, "1")
    _same_problem(read_mps_native(path), read_mps(path))
    assert os.environ[MEMORY_MODE_ENV] == "1"


def test_plain_file_keeps_memory_mode(tmp_path, monkeypatch, host_library):
    """A text file is read as before (memory mode stays as the caller set
    it), and an unset threshold stays unset after a gzip read."""
    seen = []
    real = native_mps.get_lib

    class Spy:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            attr = getattr(self._lib, name)
            if name != "hpmps_read_ex":
                return attr

            def read(*args):
                seen.append(os.environ.get(MEMORY_MODE_ENV))
                return attr(*args)
            return read

    monkeypatch.setattr(native_mps, "get_lib", lambda: Spy(real()))
    monkeypatch.setenv(MEMORY_MODE_ENV, "1")
    _same_problem(read_mps_native(MODEL), read_mps(MODEL))
    gz = str(tmp_path / "m.mps")
    with open(MODEL, "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    monkeypatch.delenv(MEMORY_MODE_ENV)
    read_mps_native(gz)
    assert seen == ["1", str(os.path.getsize(gz) + 1)]
    assert MEMORY_MODE_ENV not in os.environ


def test_missing_file_raises_as_before(tmp_path, host_library):
    with pytest.raises(ValueError):
        read_mps_native(str(tmp_path / "absent.mps"))


def _matrix(dtype):
    rng = np.random.default_rng(4)
    m, n, nnz = 40, 30, 200
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    keep = np.unique(rows * n + cols, return_index=True)[1]
    rows, cols = rows[keep], cols[keep]
    rows[rows == 7] = 8  # an empty row
    vals = rng.normal(size=len(rows))
    return csr_from_coo(rows, cols, vals, m, n, dtype, "cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_sums_take_the_kernel_route_on_the_card(monkeypatch, dtype):
    """With the device check answering "card", row sums go to the SpMM
    kernel's wrapper against a column of ones, with A's pattern and the
    per-entry values; maxima stay on scatter_reduce_."""
    calls = []

    def kernel(M, X):
        calls.append((M, X))
        return spmm_reference(M, X)

    monkeypatch.setattr(sparse, "_on_card", lambda t: True)
    monkeypatch.setattr(sparse, "csr_spmm", kernel)
    A = _matrix(dtype)
    per_entry = torch.as_tensor(np.random.default_rng(5).normal(
        size=A.nnz)).to(dtype)
    want = torch.zeros(A.nrows, dtype=dtype).index_add_(
        0, row_of_entry(A), per_entry)
    got = sparse._row_reduce(A, per_entry, "sum")
    assert got.shape == (A.nrows,) and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    (M, X), = calls
    assert M.vals is per_entry and M.indices is A.indices
    assert torch.equal(X, torch.ones((A.ncols, 1), dtype=dtype))
    one = sparse.row_one_norms(A)
    torch.testing.assert_close(one, torch.zeros(A.nrows, dtype=dtype)
                               .index_add_(0, row_of_entry(A), A.vals.abs()))
    mean = sparse.row_masked_mean(A, per_entry)
    assert float(mean[7]) == 0.0
    assert len(calls) == 3
    sparse.row_inf_norms(A)
    assert len(calls) == 3


def test_row_sums_stay_on_scatter_reduce_on_the_cpu(monkeypatch):
    def kernel(M, X):
        raise AssertionError("the kernel route ran on the CPU")

    monkeypatch.setattr(sparse, "csr_spmm", kernel)
    A = _matrix(torch.float64)
    got = sparse.row_one_norms(A)
    want = torch.zeros(A.nrows, dtype=torch.float64).scatter_reduce_(
        0, row_of_entry(A), A.vals.abs(), reduce="sum", include_self=True)
    assert torch.equal(got, want)
