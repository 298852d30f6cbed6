"""MPS/QPS file reader (pure-Python reference implementation).

Copy of hprlp_tpu/io/mps.py below its docstring, which states the
reader's semantics (free and fixed format, RANGES and BOUNDS rules, the
OBJSENSE and QUADOBJ fixes); tests/test_torch_copies.py pins the two
together.  The native reader with the same semantics is io/native_mps.py.
"""

from __future__ import annotations

import gzip
import math
import sys

import numpy as np
import scipy.sparse as sp

from ..problem import LpProblem

_VALUELESS_BOUNDS = ("FR", "MI", "PL", "BV")
_VALUED_BOUNDS = ("LO", "UP", "FX", "LI", "UI")


class MpsFormatError(ValueError):
    pass


def _open_text(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt", errors="replace")
    return open(path, "rt", errors="replace")


def _warn(msg: str) -> None:
    print(f"[mps] warning: {msg}", file=sys.stderr)


def split_fixed_card(line: str) -> list[str]:
    """Split a FIXED-format MPS card into its positional fields
    (reference: read_card_fixed, src/mps_reader.cpp:360-483):
    f1 cols 2-3, f2 5-12, f3 15-22, f4 25-36, f5 40-47, f6 50-61
    (1-based, inclusive).  Trailing empty fields are dropped; if the first
    field is empty the remaining fields shift left — the result then reads
    exactly like a free-format token list.  Fixed format is what allows
    spaces INSIDE row/column names."""
    def fld(a: int, b: int) -> str:
        return line[a:b].strip() if len(line) > a else ""

    fields = [fld(1, 3), fld(4, 12), fld(14, 22), fld(24, 36), fld(39, 47),
              fld(49, 61)]
    while fields and not fields[-1]:
        fields.pop()
    if fields and not fields[0]:
        fields = fields[1:]
    return fields


def read_mps(path: str, apply_objsense: bool = True,
             ignore_quadobj: bool = False,
             mps_format: str = "free") -> LpProblem:
    """Read an MPS/QPS file (optionally .gz) into an LpProblem.

    mps_format: "free" (whitespace-delimited, the default — matches the
    reference's build_model_from_mps, src/mps_reader.cpp:1517) or "fixed"
    (column-position cards, read_card_fixed :360-483, which permits spaces
    in names)."""
    if mps_format not in ("free", "fixed"):
        raise ValueError(f"mps_format must be 'free' or 'fixed', "
                         f"got {mps_format!r}")
    with _open_text(path) as f:
        return _parse(f, path, apply_objsense, ignore_quadobj,
                      fixed=(mps_format == "fixed"))


def _parse(f, path, apply_objsense, ignore_quadobj, fixed=False) -> LpProblem:
    name = ""
    objsense = 1  # +1 MIN (default), -1 MAX
    objname = None

    # Row bookkeeping: index 0 is the objective; constraints are 1-based,
    # rim objectives map to -1 (reference: :600-609).
    con_index: dict[str, int] = {}
    con_types: list[str] = []
    lcon: list[float] = []
    ucon: list[float] = []

    var_index: dict[str, int] = {}
    var_names: list[str] = []
    lvar: list[float] = []
    uvar: list[float] = []
    cvec: list[float] = []
    var_int: list[bool] = []

    rows_i: list[int] = []
    cols_j: list[int] = []
    vals: list[float] = []

    c0 = 0.0
    rhsname = None
    rngname = None
    bndname = None
    section = None
    pending_objsense = False
    integer_section = False
    saw_quadobj = False

    def get_var(vname: str) -> int:
        j = var_index.get(vname)
        if j is None:
            j = len(var_names)
            var_index[vname] = j
            var_names.append(vname)
            lvar.append(math.nan)
            uvar.append(math.nan)
            cvec.append(0.0)
            var_int.append(False)
        return j

    def apply_rhs(rowname: str, val: float, nline: int) -> None:
        nonlocal c0
        row = con_index.get(rowname, -2)
        if row == 0:
            c0 = -val  # objective constant (reference: :767)
        elif row == -1:
            _warn(f"ignoring RHS for rim objective {rowname} (l.{nline})")
        elif row > 0:
            idx = row - 1
            t = con_types[idx]
            if t == "E":
                lcon[idx] = val
                ucon[idx] = val
            elif t == "L":
                ucon[idx] = val
            elif t == "G":
                lcon[idx] = val
        else:
            _warn(f"unknown row {rowname} in RHS (l.{nline})")

    def apply_range(rowname: str, val: float, nline: int) -> None:
        row = con_index.get(rowname, -2)
        if row in (0, -1):
            _warn(f"objective row {rowname} in RANGES (l.{nline})")
            return
        if row == -2:
            _warn(f"unknown row {rowname} in RANGES (l.{nline})")
            return
        idx = row - 1
        t = con_types[idx]
        if t == "E":
            if val >= 0.0:
                ucon[idx] += val
            else:
                lcon[idx] += val
        elif t == "L":
            lcon[idx] = ucon[idx] - abs(val)
        elif t == "G":
            ucon[idx] = lcon[idx] + abs(val)

    for nline, raw in enumerate(f, start=1):
        line = raw.rstrip("\n").rstrip("\r")
        if not line.strip() or line.lstrip().startswith("*"):
            continue

        is_header = not line[0].isspace()
        if is_header:
            fields = line.split()
            header = fields[0].upper()
            if header == "NAME":
                if fixed:
                    # Fixed format: the model name starts at column 15
                    # (reference: :394-398) and may contain spaces.
                    name = line[14:].strip() if len(line) > 14 else ""
                else:
                    name = fields[1] if len(fields) > 1 else ""
                section = "NAME"
                continue
            if header == "OBJSENSE":
                section = "OBJSENSE"
                if len(fields) > 1:
                    objsense = -1 if fields[1].upper().startswith("MAX") else 1
                    pending_objsense = False
                else:
                    pending_objsense = True
                continue
            if header in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS",
                          "QUADOBJ", "QMATRIX", "ENDATA"):
                section = header
                if header == "ENDATA":
                    break
                continue
            _warn(f"unknown section header {header!r} (l.{nline})")
            section = None
            continue

        fields = split_fixed_card(line) if fixed else line.split()
        if not fields:
            continue
        if pending_objsense and section == "OBJSENSE":
            objsense = -1 if fields[0].upper().startswith("MAX") else 1
            pending_objsense = False
            continue

        if section == "ROWS":
            if len(fields) < 2:
                _warn(f"short ROWS line (l.{nline})")
                continue
            rtype = fields[0].upper()
            rowname = fields[1]
            # Duplicate row names are malformed MPS: routing entries to
            # either the first or the last row of the name silently
            # builds a different matrix (the native reader errors too).
            if rowname in con_index:
                raise MpsFormatError(
                    f"{path}: duplicate row name {rowname!r} (l.{nline})")
            if rtype == "N":
                if objname is None:
                    objname = rowname
                    con_index[rowname] = 0
                else:
                    _warn(f"rim objective row {rowname} (l.{nline})")
                    con_index[rowname] = -1
                continue
            if rtype not in ("E", "L", "G"):
                _warn(f"unknown row type {rtype} (l.{nline})")
                continue
            con_index[rowname] = len(con_types) + 1
            con_types.append(rtype)
            # Defaults (reference: :646-653).
            if rtype == "E":
                lcon.append(0.0)
                ucon.append(0.0)
            elif rtype == "G":
                lcon.append(0.0)
                ucon.append(math.inf)
            else:
                lcon.append(-math.inf)
                ucon.append(0.0)

        elif section == "COLUMNS":
            # Marker lines toggle the (ignored for LP) integer sections
            # (reference: :1126-1135).
            if len(fields) >= 3 and fields[1].strip("'\"").upper() == "MARKER":
                kind = fields[2].strip("'\"").upper()
                if kind == "INTORG":
                    integer_section = True
                elif kind == "INTEND":
                    integer_section = False
                continue
            if len(fields) < 3:
                _warn(f"short COLUMNS line (l.{nline})")
                continue
            j = get_var(fields[0])
            if integer_section:
                var_int[j] = True
            pairs = fields[1:]
            for k in range(0, len(pairs) - 1, 2):
                rowname, sval = pairs[k], pairs[k + 1]
                val = float(sval)
                row = con_index.get(rowname, -2)
                if row == 0:
                    cvec[j] += val
                elif row == -1:
                    pass  # rim objective coefficient dropped
                elif row > 0:
                    rows_i.append(row - 1)
                    cols_j.append(j)
                    vals.append(val)
                else:
                    _warn(f"unknown row {rowname} in COLUMNS (l.{nline})")

        elif section == "RHS":
            if len(fields) < 2:
                _warn(f"short RHS line (l.{nline})")
                continue
            # Standard form: setname row val [row val].  Some files omit the
            # set name; detect that when the first field is a known row.
            if len(fields) % 2 == 0 and fields[0] in con_index:
                pairs = fields
            else:
                if rhsname is None:
                    rhsname = fields[0]
                elif rhsname != fields[0]:
                    _warn(f"skipping rim RHS set {fields[0]} (l.{nline})")
                    continue
                pairs = fields[1:]
            for k in range(0, len(pairs) - 1, 2):
                apply_rhs(pairs[k], float(pairs[k + 1]), nline)

        elif section == "RANGES":
            if len(fields) < 2:
                continue
            if len(fields) % 2 == 0 and fields[0] in con_index:
                pairs = fields
            else:
                if rngname is None:
                    rngname = fields[0]
                elif rngname != fields[0]:
                    _warn(f"skipping rim RANGES set {fields[0]} (l.{nline})")
                    continue
                pairs = fields[1:]
            for k in range(0, len(pairs) - 1, 2):
                apply_range(pairs[k], float(pairs[k + 1]), nline)

        elif section == "BOUNDS":
            if len(fields) < 2:
                continue
            btype = fields[0].upper()
            rest = fields[1:]
            # Standard: btype setname varname [value]; tolerate a missing
            # set name when the would-be set name is a known variable.
            if btype in _VALUELESS_BOUNDS:
                if len(rest) >= 2:
                    setn, vname = rest[0], rest[1]
                elif len(rest) == 1 and rest[0] in var_index:
                    setn, vname = None, rest[0]
                else:
                    _warn(f"short BOUNDS line (l.{nline})")
                    continue
                val = None
            else:
                if len(rest) >= 3:
                    setn, vname, val = rest[0], rest[1], float(rest[2])
                elif len(rest) == 2 and rest[0] in var_index:
                    setn, vname, val = None, rest[0], float(rest[1])
                else:
                    _warn(f"short BOUNDS line (l.{nline})")
                    continue
            if setn is not None:
                if bndname is None:
                    bndname = setn
                elif bndname != setn:
                    _warn(f"skipping rim BOUNDS set {setn} (l.{nline})")
                    continue
            j = var_index.get(vname)
            if j is None:
                _warn(f"unknown column {vname} in BOUNDS (l.{nline})")
                continue
            if btype == "FR":
                lvar[j] = -math.inf
                uvar[j] = math.inf
            elif btype == "MI":
                lvar[j] = -math.inf
            elif btype == "PL":
                uvar[j] = math.inf
            elif btype == "BV":
                var_int[j] = True
                lvar[j] = 0.0
                uvar[j] = 1.0
            elif btype == "LO":
                lvar[j] = val
            elif btype == "UP":
                uvar[j] = val
            elif btype == "FX":
                lvar[j] = val
                uvar[j] = val
            elif btype == "LI":
                var_int[j] = True
                lvar[j] = val
            elif btype == "UI":
                var_int[j] = True
                uvar[j] = val
            else:
                _warn(f"unknown bound type {btype} (l.{nline})")

        elif section in ("QUADOBJ", "QMATRIX"):
            saw_quadobj = True

        # NAME / unknown sections: ignore data lines.

    if saw_quadobj and not ignore_quadobj:
        raise MpsFormatError(
            f"{path}: QUADOBJ/QMATRIX present — this is an LP solver; pass "
            "ignore_quadobj=True to drop the quadratic term (reference "
            "behaviour)")

    m = len(con_types)
    n = len(var_names)
    if n == 0:
        raise MpsFormatError(f"{path}: no variables")

    # Finalise default bounds (reference: :1156-1181).
    for j in range(n):
        lo, hi = lvar[j], uvar[j]
        if math.isnan(lo) and math.isnan(hi):
            lvar[j] = 0.0
            uvar[j] = math.inf
        elif math.isnan(lo):
            lvar[j] = -math.inf if hi < 0 else 0.0
        elif math.isnan(hi):
            uvar[j] = math.inf

    A = sp.coo_matrix(
        (np.asarray(vals, dtype=np.float64),
         (np.asarray(rows_i, dtype=np.int64), np.asarray(cols_j, dtype=np.int64))),
        shape=(m, n)).tocsr()
    A.sum_duplicates()

    c = np.asarray(cvec, dtype=np.float64)
    obj_constant = c0
    sense = 1
    if apply_objsense and objsense == -1:
        # Convert max c'x to min (-c)'x; report sense via LpProblem.
        c = -c
        obj_constant = -obj_constant
        sense = -1

    return LpProblem.from_arrays(
        A, np.asarray(lcon), np.asarray(ucon), np.asarray(lvar),
        np.asarray(uvar), c, obj_constant=obj_constant, name=name,
        objective_sense=sense)
