"""The cases of tests/test_modeling.py through both packages' modeling
layers: the expressions and constraints agree exactly, the lowered
problems are bitwise equal, and the solves (the port's on the CPU, f64)
take JAX's status and iteration count, with objective and values to
1e-9 relative."""

import numpy as np
import pytest
import torch

import hprlp_tpu.modeling as jm
import hprlp_tpu.params as jparams
import hprlp_tpu_torch.modeling as tm
import hprlp_tpu_torch.params as tparams

from test_torch_presolve import libraries  # noqa: F401 (a fixture)

# The tensors here are small: one intra-op thread keeps this test worker
# from competing with the suite's other workers for cores.
torch.set_num_threads(1)

PACKAGES = {"jax": (jm, jparams.Parameters, {}),
            "torch": (tm, tparams.Parameters, {"device": "cpu"})}


def _both(build):
    """build(modeling module) -> its result, for each package."""
    return build(jm), build(tm)


def _variable_arithmetic(mod):
    m = mod.ModelBuilder()
    x, y = m.add_variables(2)
    e = 2 * x - y / 2 + 3
    return e.get_coefficient(x.index), e.get_coefficient(y.index), e.constant


def _expression_combination(mod):
    m = mod.ModelBuilder()
    x, y, z = m.add_variables(3)
    e = (x + y) - (y - z) + 1 - 1
    return (e.get_coefficient(x.index), e.get_coefficient(y.index),
            e.get_coefficient(z.index), e.constant)


def _rsub_rmul(mod):
    m = mod.ModelBuilder()
    x = m.add_variable()
    e = 10 - 3 * x
    return e.constant, e.get_coefficient(x.index)


def _le_constant_folding(mod):
    m = mod.ModelBuilder()
    x = m.add_variable()
    con = x + 5 <= 12
    return con.sense.name, con.upper, con.lower


def _ge_eq(mod):
    m = mod.ModelBuilder()
    x = m.add_variable()
    ge, eq = x >= 3, 2 * x == 4
    return ge.lower, ge.upper, eq.lower, eq.upper


def _between(mod):
    m = mod.ModelBuilder()
    x, y = m.add_variables(2)
    con = mod.between(1, x + y + 2, 5)
    return type(con).__name__, con.lower, con.upper


def _chained_range(mod):
    m = mod.ModelBuilder()
    x = m.add_variable()
    con = (x >= 1) <= 4
    return type(con).__name__, con.lower, con.upper


EXPRESSIONS = {
    "variable_arithmetic": (_variable_arithmetic, (2.0, -0.5, 3.0)),
    "expression_combination": (_expression_combination, (1.0, 0.0, 1.0, 0.0)),
    "rsub_rmul": (_rsub_rmul, (10.0, -3.0)),
    "le_constant_folding": (_le_constant_folding, ("LE", 7.0, -np.inf)),
    "ge_eq": (_ge_eq, (3.0, np.inf, 4.0, 4.0)),
    "between": (_between, ("TwoSidedConstraint", -1.0, 3.0)),
    "chained_range": (_chained_range, ("TwoSidedConstraint", 1.0, 4.0)),
}


@pytest.mark.parametrize("case", sorted(EXPRESSIONS))
def test_expressions_match_jax(case):
    build, want = EXPRESSIONS[case]
    got_j, got_t = _both(build)
    assert got_t == got_j == want


def test_scalar_mult_only_raises_as_jax():
    for mod in (jm, tm):
        m = mod.ModelBuilder()
        x, y = m.add_variables(2)
        with pytest.raises(TypeError):
            (x + y) * (x + y)


def _demo_lp(mod):
    m = mod.ModelBuilder("minimize")
    x = m.add_variable(name="x")
    y = m.add_variable(name="y")
    m.set_objective(-3 * x - 5 * y)
    m.add_constraint(x + 2 * y <= 10)
    m.add_constraint(3 * x + y <= 12)
    return m, -26.4


def _maximize(mod):
    m = mod.ModelBuilder("maximize")
    x = m.add_variable(upper_bound=4.0)
    y = m.add_variable(upper_bound=3.0)
    m.set_objective(2 * x + y + 1)
    m.add_constraint(x + y <= 5)
    return m, 10.0


def _minimize_helper(mod):
    m = mod.ModelBuilder()
    x = m.add_variable()
    mb = mod.minimize(x)
    v = mb.add_variable(lower_bound=2.0)
    mb.set_objective(v)
    return mb, 2.0


def _range_constraint(mod):
    m = mod.ModelBuilder("minimize")
    x = m.add_variable(lower_bound=-np.inf)
    m.set_objective(x)
    m.add_constraint(mod.between(2, x, 8))
    return m, 2.0


def _maximize_helper_ranges(mod):
    """maximize() with a two-sided, a chained and an equality row."""
    m = mod.ModelBuilder()
    x, y, z = m.add_variables(3, upper_bound=6.0)
    mb = mod.maximize(x + 2 * y - z + 0.5)
    for v in (x, y, z):
        mb.variables.append(v)
    mb.add_constraint(mod.between(-1, x - y, 2))
    mb.add_constraint((x + y + z >= 1) <= 9)
    mb.add_constraint(y - z == 1)
    return mb, 53.0 / 6.0  # x = 14/3, y = 8/3, z = 5/3


SOLVES = {
    "demo_lp": _demo_lp,
    "maximize": _maximize,
    "minimize_helper": _minimize_helper,
    "range_constraint": _range_constraint,
    "maximize_helper_ranges": _maximize_helper_ranges,
}


@pytest.mark.parametrize("presolve", [True, False], ids=["presolve",
                                                         "no_presolve"])
@pytest.mark.parametrize("case", sorted(SOLVES))
def test_solve_matches_jax(case, presolve, libraries):
    out = {}
    for name, (mod, params, kw) in PACKAGES.items():
        m, opt = SOLVES[case](mod)
        res = m.solve(params(verbose=False, use_presolve=presolve), **kw)
        out[name] = (m, res, [v.value for v in m.variables],
                     m.to_problem())
    (mj, rj, vj, pj), (mt, rt, vt, pt) = out["jax"], out["torch"]
    assert (pt.A != pj.A).nnz == 0 and pt.name == pj.name
    for k in ("AL", "AU", "l", "u", "c"):
        assert getattr(pt, k).tobytes() == getattr(pj, k).tobytes(), k
    assert (pt.obj_constant, pt.objective_sense) == \
        (pj.obj_constant, pj.objective_sense)
    assert rt.status == rj.status == "OPTIMAL"
    assert rt.iter == rj.iter
    assert rt.primal_obj == pytest.approx(rj.primal_obj, rel=1e-9)
    assert rt.primal_obj == pytest.approx(opt, abs=1e-2)
    assert mt.get_objective_value() == rt.primal_obj
    np.testing.assert_allclose(vt, vj, rtol=1e-9, atol=1e-9)


def test_unsolved_raises_as_jax():
    for mod in (jm, tm):
        m = mod.ModelBuilder()
        m.add_variable()
        with pytest.raises(RuntimeError):
            m.get_objective_value()


def test_repr_and_sense_match_jax():
    got_j, got_t = _both(lambda mod: (
        repr(mod.ModelBuilder("Maximize", name="p")),
        [s.value for s in mod.Sense]))
    assert got_t == got_j
