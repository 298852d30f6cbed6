"""The plain reference against SciPy's HiGHS and linear_sum_assignment on
tiny instances, its bfloat16 rounding, and the control at a size a test
holds: the program's answers pass the limit, rounded to bfloat16 they
fail it."""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.optimize import linear_sum_assignment, linprog

from lpbench import catalog, control, reference
from lpbench.run import seeded
from conftest import TINY, tiny_cell


def _gen(name):
    with open(os.path.join(catalog.HERE, "configs", f"{name}.json")) as f:
        cfg = {**json.load(f), **TINY[name]}
    return cfg, catalog.load_module(os.path.join(
        catalog.HERE, "generators", f"{cfg['generator']}.py"))


def _highs(A, AL, AU, l, u, c):
    """HiGHS's optimum of the LP and its duals in the reference's signs:
    y_i > 0 on a row at AL, < 0 at AU; z likewise on the bounds."""
    eq = AL == AU
    ge = ~eq
    res = linprog(c, A_ub=-A[ge] if ge.any() else None,
                  b_ub=-AL[ge] if ge.any() else None,
                  A_eq=A[eq] if eq.any() else None,
                  b_eq=AL[eq] if eq.any() else None,
                  bounds=list(zip(l, np.where(np.isinf(u), None, u))),
                  method="highs")
    assert res.status == 0
    y = np.zeros(A.shape[0])
    if ge.any():
        y[ge] = -res.ineqlin.marginals
    if eq.any():
        y[eq] = res.eqlin.marginals
    z = res.lower.marginals + res.upper.marginals
    return res, y, z


@pytest.mark.parametrize("name", ["setcover_rail4284", "assign_orlib800"])
def test_optimum_of_highs_reads_zero(name):
    cfg, gen = _gen(name)
    rng = seeded(4, "cpu")
    A = gen.matrix(cfg, rng)
    mb = gen.member(cfg, rng)
    args = (A, mb["AL"], mb["AU"], mb["l"], mb["u"], mb["c"])
    res, y, z = _highs(*args)
    k = reference.kkt(*args, res.x, y, z)
    assert k["kkt"] < 1e-8
    assert k["primal_obj"] == pytest.approx(res.fun, rel=1e-12)
    assert k["dual_obj"] == pytest.approx(res.fun, rel=1e-8)
    # Each part moves where the answer is wrong.
    bad_x = res.x.copy()
    bad_x[np.argmax(res.x)] = 0.0
    assert reference.kkt(*args, bad_x, y, z)["primal"] > 1e-3
    assert reference.kkt(*args, res.x, 1.01 * y, z)["dual"] > 1e-4
    assert reference.kkt(*args, res.x, y - 1.0, z)["kkt"] > 1e-3


def test_assignment_optimum_is_linear_sum_assignments():
    cfg, gen = _gen("assign_orlib800")
    n = cfg["n"]
    A = gen.matrix(cfg, None)
    mb = gen.member(cfg, seeded(8, "cpu"))
    rows, cols = linear_sum_assignment(mb["c"].reshape(n, n))
    x = np.zeros(n * n)
    x[rows * n + cols] = 1.0
    res, y, z = _highs(A, mb["AL"], mb["AU"], mb["l"], mb["u"], mb["c"])
    k = reference.kkt(A, mb["AL"], mb["AU"], mb["l"], mb["u"], mb["c"],
                      x, y, z)
    assert k["primal"] == 0.0
    assert k["primal_obj"] == pytest.approx(res.fun, rel=1e-12)
    assert k["kkt"] < 1e-8


def test_wrong_signed_dual_is_infeasible():
    A = sp.csr_matrix(np.array([[1.0, 1.0]]))
    args = (A, np.array([1.0]), np.array([np.inf]), np.zeros(2),
            np.full(2, np.inf), np.array([1.0, 2.0]))
    good = reference.kkt(*args, np.array([1.0, 0.0]), np.array([1.0]),
                         np.array([0.0, 1.0]))
    assert good["kkt"] < 1e-15
    # y < 0 on a row with no upper bound has no finite dual objective.
    bad = reference.kkt(*args, np.array([1.0, 0.0]), np.array([-1.0]),
                        np.array([2.0, 3.0]))
    assert bad["dual"] > 0.1


def test_bfloat16_matches_torch():
    import torch

    v = np.random.default_rng(0).normal(size=10000) * 10.0 ** \
        np.random.default_rng(1).integers(-6, 6, 10000)
    want = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).to(
        torch.float64).numpy()
    assert np.array_equal(reference.bfloat16(v), want)


@pytest.mark.parametrize("name", ["setcover_rail4284.f32_1e-4",
                                  "assign_orlib800.batch64_f32_1e-4"])
def test_control_fails_where_the_program_passes(name, capsys):
    got = control.readings(tiny_cell(name), [101, 102, 103], device="cpu")
    assert got["lower"] <= got["limit"] < got["upper"]
    assert got["upper"] >= 3 * got["lower"]
