"""The spans of the two solve paths on the card: the graph capture's and
the dense probe's, which the CPU has not.  Every test here needs a CUDA
device and skips without one; the file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -q tests/test_torch_spans_gpu.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu_torch import spans
from hprlp_tpu_torch.solver import batched

pytestmark = pytest.mark.gpu

OFF = ht.Parameters(verbose=False, use_presolve=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph capture and the dense "
                    "probe run on the card only")
    return torch.device("cuda")


def _assignment(n=120, B=4, seed=0):
    """An n x n assignment LP's (A, C, AL, AU, l, u), B cost vectors: A
    has n * n * 2 entries, past the dense probe's PROBE_MIN_NNZ."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.repeat(np.arange(n), n),
                           n + np.tile(np.arange(n), n)])
    cols = np.concatenate([np.arange(n * n), np.arange(n * n)])
    A = sp.csr_matrix((np.ones(2 * n * n), (rows, cols)), shape=(2 * n,
                                                                 n * n))
    C = rng.integers(1, 101, size=(n * n, B)).astype(float)
    one = np.ones((2 * n, B))
    return (A, C, one, one.copy(), np.zeros((n * n, B)),
            np.ones((n * n, B)))


def test_solve_capture_span_is_capture_time(cuda):
    A, C, AL, AU, l, u = _assignment(B=1)
    with spans.collect() as recs:
        res = ht.solve(A, AL[:, 0], AU[:, 0], l[:, 0], u[:, 0], C[:, 0],
                       OFF, device=cuda)
    names = [s.name for s in recs]
    assert names[-1] == "solve" and "capture" in names
    cap = next(s for s in recs if s.name == "capture")
    assert ht.solve_problem.capture_time == cap.seconds
    assert res.time == next(s for s in recs if s.name == "loop").seconds


def test_solve_batched_probe_and_capture_spans(cuda):
    assert 2 * 120 * 120 >= batched.PROBE_MIN_NNZ
    with spans.collect() as recs:
        res = ht.solve_batched(*_assignment(), params=OFF, device=cuda)
    assert [s.name for s in recs] == [
        "checks", "ingest.matrix", "ingest.vectors", "ingest", "power",
        "probe", "capture", "loop", "finish", "solve_batched"]
    by = {s.name: s for s in recs}
    assert batched.solve_batched.capture_time == by["capture"].seconds
    assert by["probe"].attrs == ht.solve_batched.probe
    assert res.solve_time == by["loop"].seconds
    assert res.setup_time == by["ingest"].seconds
