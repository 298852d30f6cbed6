"""Native (C++) MPS reader binding.

Port of hprlp_tpu/io/native_mps.py: the fast path for large files, with
the semantics of the pure-Python reader in io/mps.py, which is the golden
reference in tests.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import scipy.sparse as sp

from ..native import get_lib
from ..problem import LpProblem

# The native reader loads a file of at least this many bytes whole
# (native/src/mps_reader.cpp, "memory mode") and parses it as text.
MEMORY_MODE_ENV = "HPRLP_MPS_PARALLEL_MIN_BYTES"


def is_available() -> bool:
    return get_lib() is not None


@contextlib.contextmanager
def _stream_mode_for_misnamed_gzip(path: str):
    """The native reader tells gzip by a ".gz" suffix alone before it
    picks memory mode, which would parse a gzip file under another name as
    text; its stream mode (zlib) reads both.  For a file that starts with
    gzip's magic 1f 8b but lacks the suffix, raise the memory-mode
    threshold above its size for the call, and restore it after."""
    try:
        with open(path, "rb") as f:
            gzip_magic = f.read(2) == b"\x1f\x8b"
    except OSError:  # the native reader reports the error
        gzip_magic = False
    if not gzip_magic or path.endswith(".gz"):
        yield
        return
    old = os.environ.get(MEMORY_MODE_ENV)
    os.environ[MEMORY_MODE_ENV] = str(os.path.getsize(path) + 1)
    try:
        yield
    finally:
        if old is None:
            del os.environ[MEMORY_MODE_ENV]
        else:
            os.environ[MEMORY_MODE_ENV] = old


def read_mps_native(path: str, apply_objsense: bool = True,
                    ignore_quadobj: bool = False,
                    mps_format: str = "free") -> LpProblem:
    """Read an MPS/MPS.gz file via the native reader.

    mps_format: "free" (default) or "fixed" (column-position cards that
    permit spaces in names).

    Raises RuntimeError if the native library is unavailable and
    ValueError on parse errors (same exception surface as io.mps).
    """
    if mps_format not in ("free", "fixed"):
        raise ValueError(f"mps_format must be 'free' or 'fixed', "
                         f"got {mps_format!r}")
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable; use io.mps.read_mps")
    with _stream_mode_for_misnamed_gzip(path):
        h = lib.hpmps_read_ex(path.encode(), 1 if ignore_quadobj else 0,
                              1 if mps_format == "fixed" else 0)
    try:
        st = lib.hpmps_status(h)
        if st != 0:
            raise ValueError(lib.hpmps_error(h).decode() or
                             f"failed to read {path}")
        m = lib.hpmps_m(h)
        n = lib.hpmps_n(h)
        nnz = lib.hpmps_nnz(h)
        Ap = np.zeros(m + 1, np.int64)
        Ai = np.zeros(max(nnz, 1), np.int32)
        Ax = np.zeros(max(nnz, 1), np.float64)
        AL = np.zeros(max(m, 1), np.float64)
        AU = np.zeros(max(m, 1), np.float64)
        l = np.zeros(max(n, 1), np.float64)
        u = np.zeros(max(n, 1), np.float64)
        c = np.zeros(max(n, 1), np.float64)
        lib.hpmps_get(h, Ap, Ai, Ax, AL, AU, l, u, c)
        obj_constant = lib.hpmps_obj_constant(h)
        sense = lib.hpmps_objsense(h)
        name = lib.hpmps_name(h).decode()
        if not apply_objsense and sense == -1:
            # The native reader always applies MAX; undo on request.
            c = -c[:n]
            obj_constant = -obj_constant
            sense = 1
        A = sp.csr_matrix((Ax[:nnz], Ai[:nnz], Ap), shape=(m, n))
        return LpProblem.from_arrays(
            A, AL[:m], AU[:m], l[:n], u[:n], c[:n],
            obj_constant=obj_constant, name=name, objective_sense=sense)
    finally:
        lib.hpmps_free(h)
