"""Algebraic modeling layer: build LPs with operator overloading.

Port of hprlp_tpu/modeling.py (Variable, LinearExpression, Constraint,
TwoSidedConstraint, between(), ModelBuilder, minimize(), maximize()).  It
is the JAX package's module but for ModelBuilder.solve, which solves
through this package's Model and takes a torch device;
tests/test_torch_copies.py pins the rest to the original.

Example:
    >>> m = ModelBuilder('minimize')
    >>> x = m.add_variable(name='x')
    >>> y = m.add_variable(name='y')
    >>> m.set_objective(-3 * x - 5 * y)
    >>> m.add_constraint(x + 2 * y <= 10)
    >>> m.add_constraint(3 * x + y <= 12)
    >>> r = m.solve(device='cpu')
    >>> round(r.primal_obj, 6), round(x.value, 4)
    (-26.4, 2.8)
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Union

import numpy as np
import scipy.sparse as sparse

from .params import Parameters
from .problem import LpProblem
from .results import Results

Number = (int, float, np.integer, np.floating)
Scalar = Union[int, float, np.integer, np.floating]


class Sense(enum.Enum):
    MINIMIZE = "minimize"
    MAXIMIZE = "maximize"


class ConstraintSense(enum.Enum):
    LE = "<="
    GE = ">="
    EQ = "=="
    RANGE = "range"


class Variable:
    """A decision variable.  Created via ModelBuilder.add_variable()."""

    __slots__ = ("index", "name", "lower_bound", "upper_bound", "_value")

    def __init__(self, index: int, name: Optional[str] = None,
                 lower_bound: float = 0.0, upper_bound: float = np.inf):
        self.index = index
        self.name = name or f"x{index}"
        self.lower_bound = float(lower_bound)
        self.upper_bound = float(upper_bound)
        self._value: Optional[float] = None

    @property
    def value(self) -> Optional[float]:
        """Solution value (after solve)."""
        return self._value

    @value.setter
    def value(self, val: float):
        self._value = float(val)

    def __repr__(self):
        return f"Variable({self.name})"

    def __hash__(self):
        return id(self)

    # -- arithmetic: promote to LinearExpression --
    def _expr(self) -> "LinearExpression":
        return LinearExpression({self.index: 1.0}, 0.0)

    def __add__(self, other):
        return self._expr() + other

    def __radd__(self, other):
        return self._expr() + other

    def __sub__(self, other):
        return self._expr() - other

    def __rsub__(self, other):
        return (-self._expr()) + other

    def __mul__(self, other):
        return self._expr() * other

    def __rmul__(self, other):
        return self._expr() * other

    def __neg__(self):
        return -self._expr()

    def __truediv__(self, other):
        return self._expr() / other

    # -- comparisons: build constraints --
    def __le__(self, other):
        return self._expr() <= other

    def __ge__(self, other):
        return self._expr() >= other

    def __eq__(self, other):  # noqa: A003 - intentional constraint builder
        return self._expr() == other


class LinearExpression:
    """sum_j coef_j * x_j + constant."""

    __slots__ = ("coefficients", "constant")

    def __init__(self, coefficients: Optional[Dict[int, float]] = None,
                 constant: float = 0.0):
        self.coefficients: Dict[int, float] = dict(coefficients or {})
        self.constant = float(constant)
        self._simplify()

    def _simplify(self):
        self.coefficients = {
            i: c for i, c in self.coefficients.items() if c != 0.0}

    @staticmethod
    def from_variable(var: Variable) -> "LinearExpression":
        return LinearExpression({var.index: 1.0}, 0.0)

    @staticmethod
    def from_constant(value: float) -> "LinearExpression":
        return LinearExpression({}, float(value))

    def copy(self) -> "LinearExpression":
        return LinearExpression(dict(self.coefficients), self.constant)

    def get_coefficient(self, var_index: int) -> float:
        return self.coefficients.get(var_index, 0.0)

    def __repr__(self):
        terms = [f"{c:+g}*x{i}" for i, c in sorted(self.coefficients.items())]
        if self.constant or not terms:
            terms.append(f"{self.constant:+g}")
        return "LinearExpression(" + " ".join(terms) + ")"

    @staticmethod
    def _coerce(other) -> "LinearExpression":
        if isinstance(other, LinearExpression):
            return other
        if isinstance(other, Variable):
            return LinearExpression.from_variable(other)
        if isinstance(other, Number):
            return LinearExpression.from_constant(float(other))
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        coefs = dict(self.coefficients)
        for i, c in o.coefficients.items():
            coefs[i] = coefs.get(i, 0.0) + c
        return LinearExpression(coefs, self.constant + o.constant)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return self.__add__(-o)

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __mul__(self, other):
        if not isinstance(other, Number):
            raise TypeError("LP expressions only support scalar multiplication")
        s = float(other)
        return LinearExpression({i: c * s for i, c in self.coefficients.items()},
                                self.constant * s)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return self.__mul__(-1.0)

    def __truediv__(self, other):
        if not isinstance(other, Number):
            raise TypeError("LP expressions only support scalar division")
        return self.__mul__(1.0 / float(other))

    def __le__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return Constraint(self, ConstraintSense.LE, o)

    def __ge__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return Constraint(self, ConstraintSense.GE, o)

    def __eq__(self, other):  # noqa: A003
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return Constraint(self, ConstraintSense.EQ, o)


class Constraint:
    """lhs (<=|>=|==) rhs, normalised to  expr (sense) bound  with the
    constant folded into the bound."""

    def __init__(self, lhs, sense: ConstraintSense, rhs,
                 name: Optional[str] = None):
        lhs = LinearExpression._coerce(lhs)
        rhs = LinearExpression._coerce(rhs)
        diff = lhs - rhs  # expr + const (sense) 0
        self.expr = LinearExpression(diff.coefficients, 0.0)
        self.bound = -diff.constant
        self.sense = sense
        self.name = name

    @property
    def lower(self) -> float:
        if self.sense in (ConstraintSense.GE, ConstraintSense.EQ):
            return self.bound
        return -np.inf

    @property
    def upper(self) -> float:
        if self.sense in (ConstraintSense.LE, ConstraintSense.EQ):
            return self.bound
        return np.inf

    def __repr__(self):
        return (f"Constraint({self.expr!r} {self.sense.value} {self.bound:g})")

    def __le__(self, other):
        """Chain a GE constraint into a range:  (expr >= lo) <= hi."""
        if isinstance(other, Number) and self.sense == ConstraintSense.GE:
            return TwoSidedConstraint.from_bounds(self.bound, self.expr,
                                                 float(other))
        return NotImplemented

    def __bool__(self):
        # Python evaluates `lo <= expr <= hi` as `(lo <= expr) and
        # (expr <= hi)`: the first Constraint would be truthy and silently
        # DROPPED, leaving only the upper bound.  (The reference binding
        # shares this flaw and models it silently wrong,
        # bindings/python/hprlp/modeling.py.)  Fail loudly instead.
        raise TypeError(
            "A Constraint has no truth value. For a two-sided constraint "
            "use between(lo, expr, hi) or the parenthesised form "
            "(expr >= lo) <= hi - Python's chained 'lo <= expr <= hi' "
            "would silently drop the lower bound.")


class TwoSidedConstraint(Constraint):
    """lower <= expr <= upper (maps to one row AL <= a'x <= AU)."""

    def __init__(self, expr, lower: float, upper: float,
                 name: Optional[str] = None):
        expr = LinearExpression._coerce(expr)
        self.expr = LinearExpression(expr.coefficients, 0.0)
        self._lower = float(lower) - expr.constant
        self._upper = float(upper) - expr.constant
        self.bound = self._upper
        self.sense = ConstraintSense.RANGE
        self.name = name

    @classmethod
    def from_bounds(cls, lower: Scalar, expr, upper: Scalar,
                    name: Optional[str] = None) -> "TwoSidedConstraint":
        return cls(expr, float(lower), float(upper), name)

    @property
    def lower(self) -> float:
        return self._lower

    @property
    def upper(self) -> float:
        return self._upper

    def __repr__(self):
        return (f"TwoSidedConstraint({self._lower:g} <= {self.expr!r} "
                f"<= {self._upper:g})")


def between(lower: Scalar, expr: Union[LinearExpression, Variable],
            upper: Scalar) -> TwoSidedConstraint:
    """lower <= expr <= upper as a single range constraint (parity:
    modeling.between, reference: bindings/python/hprlp/modeling.py:292)."""
    return TwoSidedConstraint.from_bounds(lower, expr, upper)


class ModelBuilder:
    """Build an LP algebraically and solve it (parity:
    modeling.ModelBuilder, reference: bindings/python/hprlp/modeling.py:662)."""

    def __init__(self, sense: Union[str, Sense] = "minimize",
                 name: Optional[str] = None):
        if isinstance(sense, str):
            sense = Sense(sense.lower())
        self.sense = sense
        self.name = name or "LP_Model"
        self.variables: List[Variable] = []
        self.objective: Optional[LinearExpression] = None
        self.constraints: List[Constraint] = []
        self._solved = False
        self._results: Optional[Results] = None

    # -- construction --
    def add_variable(self, name: Optional[str] = None,
                     lower_bound: float = 0.0,
                     upper_bound: float = np.inf) -> Variable:
        var = Variable(len(self.variables), name, lower_bound, upper_bound)
        self.variables.append(var)
        return var

    def add_variables(self, n: int, name_prefix: str = "x",
                      lower_bound: float = 0.0,
                      upper_bound: float = np.inf) -> List[Variable]:
        return [self.add_variable(f"{name_prefix}{i}", lower_bound,
                                  upper_bound) for i in range(n)]

    def set_objective(self, expr: Union[LinearExpression, Variable, Scalar]):
        e = LinearExpression._coerce(expr)
        if e is NotImplemented:
            raise TypeError(
                "Objective must be Variable, scalar, or LinearExpression")
        self.objective = e

    def add_constraint(self, constraint: Constraint,
                       name: Optional[str] = None) -> Constraint:
        if not isinstance(constraint, Constraint):
            raise TypeError(
                "Must provide a Constraint object (use <=, >=, ==, or between)")
        if name:
            constraint.name = name
        elif constraint.name is None:
            constraint.name = f"c{len(self.constraints)}"
        self.constraints.append(constraint)
        return constraint

    # -- lowering to standard form --
    def _build_standard_form(self):
        """(A, AL, AU, l, u, c, obj_constant) in the solver's standard form;
        maximisation is converted to minimisation by negating c."""
        n = len(self.variables)
        m = len(self.constraints)
        rows, cols, vals = [], [], []
        AL = np.empty(m)
        AU = np.empty(m)
        for i, con in enumerate(self.constraints):
            for j, coef in con.expr.coefficients.items():
                rows.append(i)
                cols.append(j)
                vals.append(coef)
            AL[i] = con.lower
            AU[i] = con.upper
        A = sparse.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
        A.sum_duplicates()

        l = np.array([v.lower_bound for v in self.variables])
        u = np.array([v.upper_bound for v in self.variables])
        c = np.zeros(n)
        obj_constant = 0.0
        if self.objective is not None:
            for j, coef in self.objective.coefficients.items():
                c[j] = coef
            obj_constant = self.objective.constant
        if self.sense == Sense.MAXIMIZE:
            c = -c
            obj_constant = -obj_constant
        return A, AL, AU, l, u, c, obj_constant

    def to_problem(self) -> LpProblem:
        A, AL, AU, l, u, c, k = self._build_standard_form()
        return LpProblem.from_arrays(
            A, AL, AU, l, u, c, obj_constant=k, name=self.name,
            objective_sense=-1 if self.sense == Sense.MAXIMIZE else 1)

    # -- solving --
    def solve(self, parameters: Optional[Parameters] = None,
              device=None) -> Results:
        """Solve through Model; device: a torch device, None for
        cuda:{parameters.device_number}."""
        from .model import Model

        res = Model(self.to_problem()).solve(parameters, device=device)
        self._results = res
        self._solved = True
        if res.x is not None:
            for v in self.variables:
                v.value = float(res.x[v.index])
        return res

    @property
    def results(self) -> Optional[Results]:
        return self._results

    def get_objective_value(self) -> float:
        if not self._solved or self._results is None:
            raise RuntimeError("Model has not been solved yet")
        return self._results.primal_obj

    def __repr__(self):
        return (f"ModelBuilder(name={self.name!r}, sense={self.sense.value}, "
                f"{len(self.variables)} vars, "
                f"{len(self.constraints)} constraints)")


def minimize(expr: Union[LinearExpression, Variable]) -> ModelBuilder:
    """Model with objective pre-set (parity: modeling.minimize)."""
    m = ModelBuilder("minimize")
    m.set_objective(expr)
    return m


def maximize(expr: Union[LinearExpression, Variable]) -> ModelBuilder:
    """Model with objective pre-set (parity: modeling.maximize)."""
    m = ModelBuilder("maximize")
    m.set_objective(expr)
    return m
