"""The port's MPS readers (io/mps.py, io/native_mps.py) against the JAX
package's on the same files, and prof/problems.py::write_mps round trips.

Exact: the arrays (A's indptr, indices and data, AL, AU, l, u, c) are
bitwise equal, and so are name, sense and obj_constant."""

import gzip
import os

import numpy as np
import pytest

from hprlp_tpu.io.mps import read_mps as jax_read_mps
from hprlp_tpu.io.native_mps import read_mps_native as jax_read_native
from hprlp_tpu_torch.io.mps import MpsFormatError, read_mps
from hprlp_tpu_torch.io.native_mps import read_mps_native
from hprlp_tpu_torch.prof.problems import structured_lp, write_mps

from conftest import random_lp as jax_random_lp
from test_torch_presolve import libraries  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")

SAMPLES = {
    "objsense_max": """\
NAME          MAXI
OBJSENSE
    MAX
ROWS
 N  OBJ
 L  C1
 G  C2
COLUMNS
    X1        OBJ       3.0        C1        1.0
    X1        C2        1.0
    X2        OBJ       1.5        C1        2.0
RHS
    R         OBJ       -4.0       C1        7.0
    R         C2        0.5
BOUNDS
 UP B         X2        3.0
ENDATA
""",
    "ranges_markers_dups": """\
* comment line
NAME          RNG
ROWS
 N  OBJ
 L  CL
 G  CG
 E  CE1
 E  CE2
COLUMNS
    MARKER1   'MARKER'  'INTORG'
    X         OBJ       1.0        CL        1.0
    X         CG        1.0        CE1       1.0
    X         CL        2.0
    MARKER2   'MARKER'  'INTEND'
    Y         CE2       1.0        OBJ       -0.25
RHS
    R         CL        5.0        CG        1.0
    R         CE1       3.0        CE2       3.0
RANGES
    RNG       CL        4.0        CG        2.0
    RNG       CE1       1.5        CE2       -1.5
BOUNDS
 MI B         X
 LO B         Y         -2.5
 UP B         Y         -1.0
ENDATA
""",
    "quadobj": """\
NAME          QP
ROWS
 N  OBJ
 G  R1
COLUMNS
    X         OBJ       1.0        R1        1.0
    Y         OBJ       2.0        R1        1.0
RHS
    RHS       R1        1.0
QUADOBJ
    X         X         2.0
ENDATA
""",
}


def _fixed_card(*fields):
    """A fixed-format card: fields at 1-based columns 2-3, 5-12, 15-22,
    25-36, 40-47 and 50-61."""
    line = [" "] * 61
    for s, start in zip(fields, (1, 4, 14, 24, 39, 49)):
        line[start:start + len(s)] = s
    return "".join(line).rstrip()


# Fixed format with spaces inside names, a range and bound cards.
SAMPLES["fixed_spaces"] = "\n".join([
    "NAME          SPACE MODEL",
    "ROWS",
    _fixed_card("N", "THE OBJ"),
    _fixed_card("L", "ROW A"),
    _fixed_card("G", "ROW B"),
    "COLUMNS",
    _fixed_card("", "X ONE", "THE OBJ", "-3.0", "ROW A", "1.0"),
    _fixed_card("", "X ONE", "ROW B", "3.0"),
    _fixed_card("", "X TWO", "THE OBJ", "-5.0", "ROW A", "2.0"),
    _fixed_card("", "X TWO", "ROW B", "1.0"),
    "RHS",
    _fixed_card("", "MY RHS", "ROW A", "10.0", "ROW B", "1.5"),
    "RANGES",
    _fixed_card("", "MY RNG", "ROW B", "20.0"),
    "BOUNDS",
    _fixed_card("UP", "BND SET", "X ONE", "4.0"),
    _fixed_card("MI", "BND SET", "X TWO"),
    "ENDATA", ""])

# (file or sample, reader keywords)
CASES = {
    "model.mps": ("model.mps", {}),
    "ranges_edge.mps": ("fixtures/ranges_edge.mps", {}),
    "fixed_names.mps": ("fixtures/fixed_names.mps", {"mps_format": "fixed"}),
    "bounds_defaults.mps": ("fixtures/bounds_defaults.mps", {}),
    "model.mps.gz": ("model.mps.gz", {}),
    "fixed_spaces": ("fixed_spaces", {"mps_format": "fixed"}),
    "objsense_max": ("objsense_max", {}),
    "objsense_max_unapplied": ("objsense_max", {"apply_objsense": False}),
    "ranges_markers_dups": ("ranges_markers_dups", {}),
    "quadobj_ignored": ("quadobj", {"ignore_quadobj": True}),
}


def _file(tmp_path, what):
    if what in SAMPLES:
        path = os.path.join(tmp_path, f"{what}.mps")
        with open(path, "w") as f:
            f.write(SAMPLES[what])
        return path
    if what == "model.mps.gz":
        path = os.path.join(tmp_path, what)
        with open(os.path.join(DATA, "model.mps"), "rb") as f, \
                gzip.open(path, "wb") as g:
            g.write(f.read())
        return path
    return os.path.join(DATA, what)


def assert_same_problem(pt, pj):
    assert (pt.m, pt.n, pt.nnz) == (pj.m, pj.n, pj.nnz)
    for k in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(pt.A, k), getattr(pj.A, k))
    for k in ("AL", "AU", "l", "u", "c"):
        a, b = getattr(pt, k), getattr(pj, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert (pt.name, pt.objective_sense) == (pj.name, pj.objective_sense)
    assert pt.obj_constant == pj.obj_constant


@pytest.mark.parametrize("case", sorted(CASES))
def test_python_reader_matches_jax(tmp_path, case):
    what, kw = CASES[case]
    path = _file(tmp_path, what)
    assert_same_problem(read_mps(path, **kw), jax_read_mps(path, **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_reader_matches_jax(tmp_path, case, libraries):
    what, kw = CASES[case]
    path = _file(tmp_path, what)
    pt = read_mps_native(path, **kw)
    assert_same_problem(pt, jax_read_native(path, **kw))
    # ... and the port's Python reader, the golden reference.
    assert_same_problem(read_mps(path, **kw), pt)


def test_objsense_and_quadobj_semantics(tmp_path):
    p = read_mps(_file(tmp_path, "objsense_max"))
    assert p.objective_sense == -1 and p.obj_constant == -4.0
    np.testing.assert_array_equal(p.c, [-3.0, -1.5])
    with pytest.raises(MpsFormatError, match="QUADOBJ"):
        read_mps(_file(tmp_path, "quadobj"))


def _truncated_gzip(tmp_path):
    gz = _file(tmp_path, "model.mps.gz")
    with open(gz, "rb") as f:
        blob = f.read()
    path = os.path.join(tmp_path, "trunc.mps.gz")
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    return path


def _parse_error(tmp_path):
    path = os.path.join(tmp_path, "bad.mps")
    with open(path, "w") as f:
        f.write("NAME T\nROWS\n N OBJ\n L R1\nCOLUMNS\n X OBJ 1.0 R1 1.5D+2"
                "\nRHS\n RH R1 4.0\nENDATA\n")
    return path


ERRORS = {
    "missing": lambda tmp_path: os.path.join(tmp_path, "absent.mps"),
    "parse": _parse_error,
    "truncated_gzip": _truncated_gzip,
}


def _raised(fn, path, kw=None):
    try:
        fn(path, **(kw or {}))
    except Exception as e:  # the type is what is compared
        return type(e).__name__
    return None


@pytest.mark.parametrize("error", sorted(ERRORS))
def test_readers_raise_as_jax(tmp_path, error, libraries):
    path = ERRORS[error](tmp_path)
    pairs = ((read_mps, jax_read_mps), (read_mps_native, jax_read_native))
    for port_fn, jax_fn in pairs:
        got, want = _raised(port_fn, path), _raised(jax_fn, path)
        assert got is not None and got == want, (port_fn.__name__, got, want)
    quadobj = _file(tmp_path, "quadobj")
    for port_fn, jax_fn in pairs:
        got = _raised(port_fn, quadobj)
        assert got is not None and got == _raised(jax_fn, quadobj)


def _max_free_row():
    """A maximisation with a free row, an objective constant and every
    kind of column bound."""
    from hprlp_tpu_torch.problem import LpProblem

    A = np.array([[1.0, 2.0, 0.0], [0.0, 1.0, -1.0], [3.0, 0.0, 1.0]])
    return LpProblem.from_arrays(
        A, [-np.inf, 1.0, -np.inf], [np.inf, 1.0, 5.0],
        [-np.inf, 0.0, -1.0], [np.inf, 4.0, -0.5], [-1.0, 0.5, 2.0],
        obj_constant=2.5, name="maxfree", objective_sense=-1)


ROUND_TRIP = {
    "structured_lp_1e-3": lambda: structured_lp(scale=1e-3),
    "max_free_row": _max_free_row,
    **{f"random_lp{s}": (lambda s=s: jax_random_lp(s)) for s in range(4)},
}


def _ulps(a, b):
    """Largest distance between a and b in units of b's last place (0 where
    both are the same infinity)."""
    same = a == b
    with np.errstate(invalid="ignore"):  # inf - inf where both are inf
        d = np.where(same, 0.0, np.abs(a - b) / np.spacing(np.abs(b)))
    return float(d.max()) if d.size else 0.0


@pytest.mark.parametrize("case", sorted(ROUND_TRIP))
def test_write_mps_round_trip(tmp_path, case, libraries):
    """write_mps, then the JAX package's Python reader and the port's
    native reader give back the source problem.  A, l, u, c and the
    one-sided and equality rows are bitwise equal; a two-sided row's far
    bound is exact where an MPS range can give it, else within two ulps
    (random_lp's rows that straddle zero)."""
    src = ROUND_TRIP[case]()
    path = os.path.join(tmp_path, "rt.mps")
    write_mps(src, path, block=97)  # several column blocks
    for back in (jax_read_mps(path), read_mps_native(path)):
        assert back.A.shape == src.A.shape and (back.A != src.A).nnz == 0
        for k in ("l", "u", "c"):
            np.testing.assert_array_equal(getattr(back, k), getattr(src, k))
        assert back.obj_constant == src.obj_constant
        assert back.objective_sense == src.objective_sense
        one_sided = ~(np.isfinite(src.AL) & np.isfinite(src.AU)) \
            | (src.AL == src.AU)
        for k in ("AL", "AU"):
            got, want = getattr(back, k), getattr(src, k)
            np.testing.assert_array_equal(got[one_sided], want[one_sided])
            assert _ulps(got, want) <= 2.0, k
        if case.startswith("structured"):  # every row exact
            np.testing.assert_array_equal(back.AL, src.AL)
            np.testing.assert_array_equal(back.AU, src.AU)
