"""One LP a call from its MPS file through the front door that reads files,
`hprlp_tpu_torch.solve_mps` (model.py: the reader, presolve, the solve,
postsolve and the original-space validation), with
Parameters(**traffic["parameters"]).

The pool's LPs are drawn by the configuration's generator and written once,
before the window, each to a free-format MPS file of its own by this
module's plain writer (not the program's), in a temporary directory
removed at exit; the files are then warm in the page cache.  A call hands
the program the path alone.  The answers are judged against the
generator's arrays, never against what the program read, so a misread
file fails the check.  The LP's shape, the answers kept and the members
are the single-LP entry's (entries/solve.py).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import numpy as np
import scipy.sparse as sp

import hprlp_tpu_torch as ht
from lpbench import catalog

_SOLVE = catalog.load_module(os.path.join(os.path.dirname(__file__),
                                          "solve.py"))
shape, keep, member = _SOLVE.shape, _SOLVE.keep, _SOLVE.member

SPANS = ("read", "postsolve", "validate")
PRESOLVE_COUNTS = ("rows_removed", "cols_removed", "nnz_removed", "rounds")


def _names(letter: str, count: int) -> tuple:
    """The names <letter><i> for i < count, without padding, as a field:
    (a (count, width) uint8 array of the digits right-justified, the mask
    of the characters that are written)."""
    width = len(str(max(count - 1, 0)))
    i = np.arange(count, dtype=np.int64)[:, None]
    powers = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    text = np.empty((count, width + 1), np.uint8)
    text[:, 0] = ord(letter)
    text[:, 1:] = i // powers % 10 + 48
    digits = np.maximum((i >= powers).sum(1), 1)
    written = np.ones(text.shape, bool)
    written[:, 1:] = np.arange(width) >= width - digits[:, None]
    return text, written


def _numbers(v: np.ndarray) -> tuple:
    """The values v as exact decimals without padding: (a field of the
    distinct values, each entry's row in it)."""
    uniq, which = np.unique(v, return_inverse=True)
    text = [(str(int(x)) if x == np.round(x) and abs(x) < 2**53
             else repr(float(x))).encode() for x in uniq]
    width = max(len(t) for t in text)
    table = np.frombuffer(b"".join(t.ljust(width) for t in text),
                          np.uint8).reshape(len(text), width)
    lengths = np.array([len(t) for t in text])
    return (table, np.arange(width) < lengths[:, None]), which


def _stack(*fields) -> tuple:
    """The fields' rows one after another, in one field of the widest's
    width."""
    width = max(f[0].shape[1] for f in fields)
    text = np.concatenate([np.pad(f[0], ((0, 0), (0, width - f[0].shape[1])),
                                  constant_values=32) for f in fields])
    written = np.concatenate([np.pad(f[1], ((0, 0),
                                            (0, width - f[1].shape[1])))
                              for f in fields])
    return text, written


def _pick(field, rows) -> tuple:
    return field[0][rows], field[1][rows]


def _lines(*fields) -> bytes:
    """A line per row of the fields: a space, then each field's written
    characters, with one space between fields."""
    rows = fields[0][0].shape[0]
    width = sum(f[0].shape[1] + 1 for f in fields) + 1
    text = np.full((rows, width), 32, np.uint8)
    written = np.ones((rows, width), bool)
    at = 1
    for t, w in fields:
        text[:, at:at + t.shape[1]] = t
        written[:, at:at + t.shape[1]] = w
        at += t.shape[1] + 1
    text[:, -1] = 10
    return text[written].tobytes()


def _constant(word: bytes, rows: int) -> tuple:
    text = np.frombuffer(word, np.uint8)[None, :].repeat(rows, 0)
    return text, np.ones(text.shape, bool)


def write_mps(path: str, A, AL, AU, l, u, c) -> int:
    """Write min c'x s.t. AL <= A x <= AU, l <= x <= u as a free-format
    MPS file: rows R<i>, columns C<j>, the objective OBJ, values as exact
    decimals, fields parted by one space.  Rows must be equalities or
    one-sided and the bounds [0, inf), the only forms the benchmark's LPs
    take.  Returns the file's bytes."""
    m, n = A.shape
    AL, AU, l, u, c = (np.asarray(v, np.float64) for v in (AL, AU, l, u, c))
    if np.any(l != 0) or not np.all(np.isposinf(u)):
        raise ValueError("only the bounds 0 <= x < inf are written")
    eq = AL == AU
    ge = ~eq & np.isfinite(AL) & np.isposinf(AU)
    le = ~eq & np.isneginf(AL) & np.isfinite(AU)
    if not np.all(eq | ge | le):
        raise ValueError("only equality and one-sided rows are written")
    # The objective as row 0 above A's rows, column by column.
    M = sp.vstack([sp.csr_matrix(c[None, :]), sp.csr_matrix(A)]).tocsc()
    M.eliminate_zeros()
    M.sort_indices()
    col = np.repeat(np.arange(n), np.diff(M.indptr))
    rows = _stack(_constant(b"OBJ", 1), _names("R", m))
    values, which = _numbers(M.data)
    kinds = np.where(eq, ord("E"), np.where(ge, ord("G"), ord("L")))
    rhs = np.where(le, AU, AL)
    set_rows = np.nonzero(rhs)[0]
    rhs_values, rhs_which = _numbers(rhs[set_rows])
    with open(path, "wb") as f:
        f.write(b"NAME LP\nROWS\n N OBJ\n")
        f.write(_lines((kinds.astype(np.uint8)[:, None],
                        np.ones((m, 1), bool)),
                       _pick(rows, np.arange(1, m + 1))))
        f.write(b"COLUMNS\n")
        f.write(_lines(_pick(_names("C", n), col), _pick(rows, M.indices),
                       _pick(values, which)))
        f.write(b"RHS\n")
        if set_rows.size:
            f.write(_lines(_constant(b"RHS", set_rows.size),
                           _pick(rows, 1 + set_rows),
                           _pick(rhs_values, rhs_which)))
        f.write(b"ENDATA\n")
    return os.path.getsize(path)


def make_pool(generator, config: dict, traffic: dict, gen) -> list:
    where = tempfile.mkdtemp(prefix="lpbench-mps-")
    atexit.register(shutil.rmtree, where, True)
    pool = []
    for k in range(traffic["pool"]):
        inst = {"A": generator.matrix(config, gen),
                **generator.member(config, gen),
                "path": os.path.join(where, f"lp{k}.mps")}
        write_mps(inst["path"], *member(inst, 0))
        pool.append(inst)
    return pool


def fresh(inst: dict) -> tuple:
    """The file's path: the caller's input is the file."""
    return (inst["path"],)


def call(args: tuple, parameters: dict, device=None):
    return ht.solve_mps(args[0], ht.Parameters(**parameters), device=device)


def _spans() -> dict:
    """The seconds of the last call's spans "read", "postsolve" and
    "validate", and the attrs of its "presolve" (what presolve removed and
    its rounds); None each where the program records none."""
    try:
        from hprlp_tpu_torch import spans
    except ImportError:
        spans = None
    by = {s.name: s for s in spans.last()} if spans else {}
    attrs = by["presolve"].attrs if "presolve" in by else {}
    return {**{f"{k}_s": by[k].seconds if k in by else None for k in SPANS},
            **{k: attrs.get(k) for k in PRESOLVE_COUNTS}}


def record(res) -> dict:
    """The single-LP entry's record, presolve's seconds, the spans of the
    file's path and presolve's counts."""
    return {**_SOLVE.record(res), "presolve_s": res.presolve_time,
            **_spans()}
