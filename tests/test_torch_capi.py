"""The C ABI on the port (hprlp_tpu_torch/capi.py): native/src/
hprlp_c_api.cpp built into the port's _build/, driving the port's server
through a launcher that runs on the CPU.

After tests/test_c_api.py: the C and C++ examples compiled and run, a
ctypes consumer (solve, solve_batched, from an MPS file, CSC ingestion,
hostile paths, precision "mixed"), and the launcher's refusal of any
invocation but "-m hprlp_tpu.server".  Each test skips without a
compiler, as the JAX package's does."""

import ctypes as ct
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu_torch import capi

from test_c_api import _BatchedResults, _Params, _Results
from test_torch_presolve import libraries  # noqa: F401 (a fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "data", "model.mps")
INCLUDE = os.path.join(ROOT, "native", "include")
BUILD = os.path.dirname(capi.LIB_PATH)


def _need(*names):
    for name in names:
        if shutil.which(name) is None:
            pytest.skip(f"no {name}")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's C ABI library and a CPU launcher."""
    _need("g++")
    lib = capi.build()
    launcher = capi.write_launcher(
        str(tmp_path_factory.mktemp("launcher") / "python"), device="cpu")
    return lib, launcher


@pytest.fixture
def env(built, monkeypatch):
    """This process's environment pointed at the port, for the ctypes
    consumer's worker and for the examples."""
    lib, launcher = built
    monkeypatch.setenv("HPRLP_TPU_PYTHON", launcher)
    monkeypatch.setenv("HPRLP_TPU_ROOT", ROOT)
    monkeypatch.setenv("LD_LIBRARY_PATH", BUILD)
    return dict(os.environ)


@pytest.mark.parametrize("name,args", [
    ("c/example_direct_lp.c", ()),
    ("c/example_mps_file.c", (MODEL,)),
    ("c/example_batched_lp.c", ()),
    ("cpp/example_direct_lp.cpp", ()),
    ("cpp/example_mps_file.cpp", (MODEL,)),
])
def test_example_compiles_and_solves(tmp_path, env, name, args, libraries):
    cpp = name.endswith(".cpp")
    compiler = "g++" if cpp else "gcc"
    _need(compiler)
    exe = str(tmp_path / "example")
    subprocess.run([compiler, *(["-std=c++17"] if cpp else []),
                    os.path.join(ROOT, "examples", name), "-I" + INCLUDE,
                    "-L" + BUILD, "-lhprlp_tpu", "-o", exe], check=True)
    r = subprocess.run([exe, *args], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OPTIMAL" in r.stdout and "OK" in r.stdout
    # The worker the library started is the port's server, on the CPU.
    assert "device cpu" in r.stderr.splitlines()
    assert any(x.startswith("kernel launches ")
               for x in r.stderr.splitlines())


@pytest.fixture(scope="module")
def lib(built):
    """The library through ctypes, one worker for the module; stopped at
    the end."""
    L = ct.CDLL(built[0])
    dp = ct.POINTER(ct.c_double)
    L.hprlp_parameters_default.argtypes = [ct.POINTER(_Params)]
    L.hprlp_parameters_default.restype = None
    for name in ("hprlp_create_model_from_arrays",
                 "hprlp_create_model_from_arrays_csc"):
        fn = getattr(L, name)
        fn.restype = ct.c_void_p
        fn.argtypes = [ct.c_int64, ct.c_int64, ct.POINTER(ct.c_int64),
                       ct.POINTER(ct.c_int32), dp, dp, dp, dp, dp, dp,
                       ct.c_double]
    L.hprlp_create_model_from_mps.restype = ct.c_void_p
    L.hprlp_create_model_from_mps.argtypes = [ct.c_char_p]
    L.hprlp_solve.restype = ct.POINTER(_Results)
    L.hprlp_solve.argtypes = [ct.c_void_p, ct.POINTER(_Params)]
    L.hprlp_solve_batched.restype = ct.POINTER(_BatchedResults)
    L.hprlp_solve_batched.argtypes = [ct.c_void_p, ct.c_int64, dp, dp, dp,
                                      dp, dp, dp, ct.POINTER(_Params)]
    L.hprlp_free_results.argtypes = [ct.POINTER(_Results)]
    L.hprlp_free_results.restype = None
    L.hprlp_free_batched_results.argtypes = [ct.POINTER(_BatchedResults)]
    L.hprlp_free_batched_results.restype = None
    L.hprlp_free_model.argtypes = [ct.c_void_p]
    L.hprlp_free_model.restype = None
    L.hprlp_last_error.restype = ct.c_char_p
    L.hprlp_shutdown.restype = None
    yield L
    L.hprlp_shutdown()


def _params(L, **kw):
    p = _Params()
    L.hprlp_parameters_default(ct.byref(p))
    for k, v in kw.items():
        setattr(p, k, v)
    return p


INF = float("inf")


def _arrays(csc=False):
    """The demo LP, its A in CSR or CSC."""
    Ap = (ct.c_int64 * 3)(0, 2, 4)
    Ai = (ct.c_int32 * 4)(0, 1, 0, 1)
    Ax = ((ct.c_double * 4)(1.0, 3.0, 2.0, 1.0) if csc
          else (ct.c_double * 4)(1.0, 2.0, 3.0, 1.0))
    vec = lambda *v: (ct.c_double * len(v))(*v)
    return (2, 2, Ap, Ai, Ax, vec(-INF, -INF), vec(10.0, 12.0),
            vec(0.0, 0.0), vec(INF, INF), vec(-3.0, -5.0), 0.0)


def _in_process(**kw):
    return ht.solve(np.array([[1.0, 2.0], [3.0, 1.0]]), [-INF, -INF],
                    [10.0, 12.0], [0.0, 0.0], [INF, INF], [-3.0, -5.0],
                    ht.Parameters(verbose=False, **kw), device="cpu")


@pytest.mark.parametrize("case", ["csr_f64", "csc_f64", "mps_auto",
                                  "csr_mixed"])
def test_ctypes_solve(lib, env, case, libraries):
    """hprlp_solve on each ingestion route; the iteration count is the
    in-process solve's with the same parameters."""
    precision = case.split("_")[1]
    if case == "mps_auto":
        model = lib.hprlp_create_model_from_mps(MODEL.encode())
    else:
        create = (lib.hprlp_create_model_from_arrays_csc
                  if case.startswith("csc") else
                  lib.hprlp_create_model_from_arrays)
        model = create(*_arrays(csc=case.startswith("csc")))
    assert model
    tol = 1e-8 if precision == "mixed" else 1e-6
    res = lib.hprlp_solve(model, ct.byref(_params(
        lib, stop_tol=tol, precision=precision.encode())))
    assert res, lib.hprlp_last_error()
    r = res.contents
    want = _in_process(stop_tol=tol, precision=precision)
    assert r.status == b"OPTIMAL" == want.status.encode()
    assert r.iter == want.iter
    assert r.primal_obj == pytest.approx(want.primal_obj, rel=1e-9)
    assert r.primal_obj == pytest.approx(-26.4, abs=1e-3)
    x = np.ctypeslib.as_array(r.x, shape=(r.n,)).copy()
    np.testing.assert_allclose(x, want.x, rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(x, [2.8, 3.6], atol=1e-3)
    lib.hprlp_free_results(res)
    lib.hprlp_free_model(model)


@pytest.mark.parametrize("source", ["arrays", "mps"])
def test_ctypes_solve_batched(lib, env, source, libraries):
    """B = 3 LPs sharing the demo A (member 0 the ground-truth LP), from
    arrays or from the MPS file (the mps_dims route), against the
    in-process solve_batched."""
    model = (lib.hprlp_create_model_from_mps(MODEL.encode())
             if source == "mps" else
             lib.hprlp_create_model_from_arrays(*_arrays()))
    assert model
    B = 3
    C = np.array([[-3, -5], [-2, -6], [-4, -4]], float).T
    AL = np.full((2, B), -INF)
    AU = np.array([[10, 12], [9, 13], [11, 11]], float).T
    lo = np.zeros((2, B))
    hi = np.array([[INF, INF], [INF, INF], [4.0, INF]]).T
    # Column-major (dim, B) buffers, kept alive through the call.
    keep = [np.ascontiguousarray(a.ravel(order="F"))
            for a in (C, AL, AU, lo, hi)]
    ptrs = [k.ctypes.data_as(ct.POINTER(ct.c_double)) for k in keep]
    res = lib.hprlp_solve_batched(model, B, *ptrs, None,
                                  ct.byref(_params(lib, stop_tol=1e-6)))
    assert res, lib.hprlp_last_error()
    r = res.contents
    assert (r.m, r.n, r.batch_size) == (2, 2, B)
    status = [ct.string_at(ct.addressof(r.status.contents) + 64 * k).decode()
              for k in range(B)]
    want = ht.solve_batched(np.array([[1.0, 2.0], [3.0, 1.0]]), C, AL, AU,
                            lo, hi, params=ht.Parameters(verbose=False,
                                                         stop_tol=1e-6),
                            device="cpu")
    assert status == want.status == ["OPTIMAL"] * B
    np.testing.assert_array_equal(np.ctypeslib.as_array(r.iter, (B,)),
                                  want.iter)
    np.testing.assert_allclose(np.ctypeslib.as_array(r.primal_obj, (B,)),
                               want.primal_obj, rtol=1e-9)
    np.testing.assert_allclose(
        np.ctypeslib.as_array(r.x, (2 * B,)).reshape(2, B, order="F"),
        want.x, rtol=1e-7, atol=1e-7)
    assert r.primal_obj[0] == pytest.approx(-26.4, abs=1e-3)
    lib.hprlp_free_batched_results(res)
    lib.hprlp_free_model(model)


def test_ctypes_hostile_paths(lib, env, libraries):
    """Hostile MPS paths round-trip the line-delimited pipe: each solve
    answers a clean ERROR, and the same worker still solves afterwards."""
    p = _params(lib, stop_tol=1e-4)
    for path in (b"/no/such\nfile.mps", b'/tmp/we"ird.mps',
                 b"/tmp/back\\slash.mps", b"/tmp/ctrl\x01\x1f.mps",
                 b"/tmp/\xc3\xbcnicode.mps", b"\ttabs\tin\tpath"):
        model = lib.hprlp_create_model_from_mps(path)
        res = lib.hprlp_solve(model, ct.byref(p))
        assert res, (path, lib.hprlp_last_error())
        assert res.contents.status == b"ERROR", path
        lib.hprlp_free_results(res)
        lib.hprlp_free_model(model)
    model = lib.hprlp_create_model_from_mps(MODEL.encode())
    res = lib.hprlp_solve(model, ct.byref(p))
    assert res and res.contents.status == b"OPTIMAL"
    lib.hprlp_free_results(res)
    lib.hprlp_free_model(model)


@pytest.mark.parametrize("argv", [
    [], ["-c", "print(1)"], ["-m", "hprlp_tpu.cli"], ["-m"],
    ["hprlp_tpu.server"], ["-m", "hprlp_tpu_torch.server"],
], ids=["none", "c", "other_module", "m_alone", "no_m", "port_module"])
def test_launcher_refuses_other_invocations(built, argv):
    r = subprocess.run([built[1], *argv], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 2
    assert r.stdout == ""
    assert "expected '-m hprlp_tpu.server [args]'" in r.stderr


def test_launcher_passes_arguments_to_the_port_server(built, tmp_path):
    """MATLAB's one-shot transport through the launcher: the JAX module
    name in, the port's server out, arguments passed through."""
    req, resp = tmp_path / "req.json", tmp_path / "resp.json"
    req.write_text(json.dumps({"op": "ping"}))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([built[1], "-m", "hprlp_tpu.server", "--request",
                        str(req), "--response", str(resp)], env=env,
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(resp.read_text()) == {"ok": True, "result": "pong"}
    # The JAX server writes no device line: this is the port's.
    assert r.stderr.splitlines()[0] == "device cpu"


@pytest.mark.parametrize("device,flag", [
    (None, []), ("cpu", ["--device", "cpu"]), (0, ["--device", "0"]),
    (1, ["--device", "1"]),
])
def test_launcher_device_flag(tmp_path, device, flag):
    path = capi.write_launcher(str(tmp_path / "py"), device=device)
    assert os.access(path, os.X_OK)
    with open(path) as f:
        text = f.read()
    assert text.startswith("#!/bin/sh\n")
    line = next(x for x in text.splitlines() if "exec " in x)
    assert line.split() == ["exec", sys.executable, "-m",
                            "hprlp_tpu_torch.server", *flag, '"$@"']


@pytest.mark.parametrize("device", ["gpu", "cuda:0", -1, "0"])
def test_launcher_rejects_a_bad_device(tmp_path, device):
    with pytest.raises(ValueError, match="CUDA index"):
        capi.write_launcher(str(tmp_path / "py"), device=device)
    assert not os.path.exists(tmp_path / "py")


def test_module_builds_and_prints_the_exports(built):
    r = subprocess.run([sys.executable, "-m", "hprlp_tpu_torch.capi",
                        "--device", "cpu"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == f"library {capi.LIB_PATH}"
    exports = dict(x[len("export "):].split("=", 1) for x in lines[1:])
    assert exports == capi.environ("cpu")
    assert exports["HPRLP_TPU_ROOT"] == ROOT
