"""Each configuration's generator: its published shape exactly, the same
arrays from the same seed, and the structure its source describes."""

import json
import os

import numpy as np
import pytest

from lpbench import catalog
from lpbench.run import seeded

CONFIGS = ("setcover_rail4284", "assign_orlib800")


def _load(name):
    with open(os.path.join(catalog.HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    gen = catalog.load_module(os.path.join(catalog.HERE, "generators",
                                           f"{cfg['generator']}.py"))
    return cfg, gen


@pytest.mark.parametrize("name", CONFIGS)
def test_published_shape_and_repeatable(name):
    cfg, gen = _load(name)
    A1 = gen.matrix(cfg, seeded(2**31 + 7, "cpu"))
    A2 = gen.matrix(cfg, seeded(2**31 + 7, "cpu"))
    assert A1.shape == (cfg["rows"], cfg["cols"])
    assert A1.nnz == cfg["nnz"]
    assert np.array_equal(A1.indptr, A2.indptr)
    assert np.array_equal(A1.indices, A2.indices)
    assert np.all(A1.data == 1.0)
    A1.sum_duplicates()
    assert A1.nnz == cfg["nnz"]  # no entry twice
    mb1 = gen.member(cfg, seeded(3, "cpu"))
    mb2 = gen.member(cfg, seeded(3, "cpu"))
    for key in ("AL", "AU", "l", "u", "c"):
        assert np.array_equal(mb1[key], mb2[key])
    assert mb1["AL"].size == cfg["rows"] and mb1["c"].size == cfg["cols"]


def test_setcover_columns_and_costs():
    cfg, gen = _load("setcover_rail4284")
    cfg = {**cfg, "rows": 500, "cols": 20000, "nnz": 206000}
    A = gen.matrix(cfg, seeded(1, "cpu"))
    per_col = np.diff(A.tocsc().indptr)
    assert set(np.unique(per_col)) == {10, 11}
    assert (per_col == 11).sum() == 6000
    assert np.diff(A.indptr).min() > 0  # every row can be covered
    c = gen.member(cfg, seeded(1, "cpu"))["c"]
    assert set(np.unique(c)) == {1.0, 2.0, 3.0}
    # Another seed draws other rows.
    B = gen.matrix(cfg, seeded(2, "cpu"))
    assert not np.array_equal(A.indices, B.indices)


def test_assignment_rows_sum_rows_and_columns_of_x():
    cfg, gen = _load("assign_orlib800")
    n = 5
    A = gen.matrix({**cfg, "n": n}, None).toarray()
    X = np.arange(n * n, dtype=float).reshape(n, n)
    assert np.array_equal(A @ X.ravel(),
                          np.concatenate([X.sum(axis=1), X.sum(axis=0)]))
    c = gen.member(cfg, seeded(0, "cpu"))["c"]
    assert c.min() >= 1 and c.max() <= 100 and np.all(c == np.round(c))
