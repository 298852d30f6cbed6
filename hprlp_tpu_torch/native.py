"""ctypes bindings to the host library: the presolver, the MPS reader and
the parallel page touch of _malloc.preheat.

Port of hprlp_tpu/native.py.  The C++ sources are the JAX package's own
(native/src/hpres.cpp, mps_reader.cpp, and lane_fill.cpp for the
`hprlp_parallel_touch` the reader and _malloc.preheat call); this module compiles them with
the flags of native/Makefile into `_build/libhprlp_host.so` next to this
package on first use, and never writes into native/.  The lane-layout and
scaling entry points of the JAX package's library are TPU layout and are
not bound here.

The build runs under an fcntl lock with a timeout, links to a temporary
file and renames it, so processes that start together build once and none
loads a half-written library.  Without g++ or zlib, `get_lib()` returns
None and `lib_error` says why: the callers then read MPS files in Python
and solve without presolve, the JAX package's posture.
"""

from __future__ import annotations

import ctypes as ct
import fcntl
import os
import subprocess
import tempfile
import time

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
SOURCES = tuple(os.path.join(_NATIVE_DIR, "src", name) for name in
                ("hpres.cpp", "mps_reader.cpp", "lane_fill.cpp"))
HEADERS = tuple(os.path.join(_NATIVE_DIR, "include", name) for name in
                ("hpres.h", "hpmps.h"))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libhprlp_host.so")
# native/Makefile:13-14, 39: CXXFLAGS, LDFLAGS and -lz.  -march=native
# matters: without it FMA contraction moves the last bits of the reduced
# bounds, and the reduced problem is no longer the JAX package's.
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
            "-march=native", "-pthread")
LDFLAGS = ("-shared", "-pthread")
BUILD_TIMEOUT_S = 120.0

_lib = None
lib_error: str | None = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _stale(path: str, inputs) -> bool:
    """True if `path` is missing or older than one of `inputs` (make's
    rule)."""
    if not os.path.exists(path):
        return True
    built = os.path.getmtime(path)
    return any(os.path.getmtime(p) > built for p in inputs)


def build_library(path: str, sources, headers, flags=(), libs=(),
                  timeout: float = BUILD_TIMEOUT_S) -> str:
    """Compile `sources` with g++ (native/Makefile's CXXFLAGS and LDFLAGS,
    then `flags`, linking `libs`) into the shared library `path` if it is
    missing or older than a source or header.  Returns `path`.  Raises
    RuntimeError if g++ fails or another process holds the build lock
    for longer than `timeout` seconds."""
    inputs = tuple(sources) + tuple(headers)
    if not _stale(path, inputs):
        return path
    build_dir = os.path.dirname(path)
    os.makedirs(build_dir, exist_ok=True)
    deadline = time.monotonic() + timeout
    with open(os.path.splitext(path)[0] + ".lock", "w") as lock:
        while True:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"timed out after {timeout:.0f} s "
                                       f"waiting for the build lock of "
                                       f"{path}") from None
                time.sleep(0.1)
        try:
            if not _stale(path, inputs):  # built while we waited
                return path
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            cmd = ["g++", *CXXFLAGS, *LDFLAGS, *flags,
                   "-I" + os.path.join(_NATIVE_DIR, "include"), *sources,
                   "-o", tmp, *libs]
            try:
                proc = subprocess.run(
                    cmd, capture_output=True, text=True,
                    timeout=max(1.0, deadline - time.monotonic()))
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                                       f"{proc.stderr[-4000:]}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def build(timeout: float = BUILD_TIMEOUT_S) -> str:
    """Compile the host library if it is missing or stale.  Returns its
    path.  Raises RuntimeError if g++ fails or another process holds the
    build lock for longer than `timeout` seconds."""
    return build_library(LIB_PATH, SOURCES, HEADERS, libs=("-lz",),
                         timeout=timeout)


def _configure(lib):
    """The hpres_* and hpmps_* signatures of hprlp_tpu/native.py, and its
    hprlp_parallel_touch (100-101)."""
    h = ct.c_void_p
    lib.hpres_presolve.restype = h
    lib.hpres_presolve.argtypes = [
        ct.c_int64, ct.c_int64, _i64p, _i32p, _f64p, _f64p, _f64p, _f64p,
        _f64p, _f64p, ct.c_double, ct.c_int]
    lib.hpres_presolve_ex.restype = h
    lib.hpres_presolve_ex.argtypes = [
        ct.c_int64, ct.c_int64, _i64p, _i32p, _f64p, _f64p, _f64p, _f64p,
        _f64p, _f64p, ct.c_double, ct.c_int, ct.c_double, ct.c_int]
    lib.hpres_status.restype = ct.c_int
    lib.hpres_status.argtypes = [h]
    for fn in ("hpres_reduced_m", "hpres_reduced_n", "hpres_reduced_nnz"):
        getattr(lib, fn).restype = ct.c_int64
        getattr(lib, fn).argtypes = [h]
    lib.hpres_obj_shift.restype = ct.c_double
    lib.hpres_obj_shift.argtypes = [h]
    lib.hpres_get_reduced.restype = None
    lib.hpres_get_reduced.argtypes = [h, _i64p, _i32p, _f64p, _f64p, _f64p,
                                      _f64p, _f64p, _f64p]
    lib.hpres_get_maps.restype = None
    lib.hpres_get_maps.argtypes = [h, _i64p, _i64p]
    lib.hpres_postsolve.restype = None
    lib.hpres_postsolve.argtypes = [h, _f64p, _f64p, _f64p, _f64p, _f64p,
                                    _f64p]
    lib.hpres_stats.restype = None
    lib.hpres_stats.argtypes = [h] + [ct.POINTER(ct.c_int64)] * 4
    lib.hpres_free.restype = None
    lib.hpres_free.argtypes = [h]
    lib.hpres_report.restype = ct.c_int64
    lib.hpres_report.argtypes = [h, ct.c_char_p, ct.c_int64]

    lib.hpmps_read.restype = h
    lib.hpmps_read.argtypes = [ct.c_char_p, ct.c_int]
    lib.hpmps_read_ex.restype = h
    lib.hpmps_read_ex.argtypes = [ct.c_char_p, ct.c_int, ct.c_int]
    lib.hpmps_status.restype = ct.c_int
    lib.hpmps_status.argtypes = [h]
    lib.hpmps_error.restype = ct.c_char_p
    lib.hpmps_error.argtypes = [h]
    for fn in ("hpmps_m", "hpmps_n", "hpmps_nnz"):
        getattr(lib, fn).restype = ct.c_int64
        getattr(lib, fn).argtypes = [h]
    lib.hpmps_obj_constant.restype = ct.c_double
    lib.hpmps_obj_constant.argtypes = [h]
    lib.hpmps_objsense.restype = ct.c_int
    lib.hpmps_objsense.argtypes = [h]
    lib.hpmps_name.restype = ct.c_char_p
    lib.hpmps_name.argtypes = [h]
    lib.hpmps_get.restype = None
    lib.hpmps_get.argtypes = [h, _i64p, _i32p, _f64p, _f64p, _f64p, _f64p,
                              _f64p, _f64p]
    lib.hpmps_free.restype = None
    lib.hpmps_free.argtypes = [h]

    # _malloc.preheat's parallel page touch (native/src/lane_fill.cpp).
    _u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.hprlp_parallel_touch.restype = None
    lib.hprlp_parallel_touch.argtypes = [_u8p, ct.c_int64]


def get_lib():
    """The loaded host library, or None if it cannot be built or loaded
    (then `lib_error` holds the reason).  Loaded with ctypes' default
    RTLD_LOCAL, so the JAX package's library, which exports the same
    names, can be loaded in the same process."""
    global _lib, lib_error
    if _lib is not None or lib_error is not None:
        return _lib
    try:
        lib = ct.CDLL(build())
        _configure(lib)
        _lib = lib
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        lib_error = str(e)
    return _lib


def is_available() -> bool:
    return get_lib() is not None
