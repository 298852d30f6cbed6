"""The port's solver server (hprlp_tpu_torch/server.py) against the JAX
package's (hprlp_tpu/server.py), on the CPU.

In process, `handle(req, device="cpu")` answers the same requests as
`hprlp_tpu.server.handle`: the same status, iteration counts and
milestones, objectives to 1e-9 relative and x, y, z to 1e-7 (the bar of
tests/test_torch_model_mps.py), and the same error responses.  Then the
three transports as the wrappers use them (pipes, one-shot files, a watch
directory), in a subprocess with --device cpu, and the server's refusal
to solve on the CPU unasked."""

import base64
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu.server as jserver
import hprlp_tpu_torch.server as tserver
from hprlp_tpu_torch.server import _enc, handle

from conftest import random_lp as jax_random_lp
from test_torch_presolve import libraries  # noqa: F401 (a fixture)

# The tensors here are small: one intra-op thread keeps this test worker
# from competing with the suite's other workers for cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "data", "model.mps")
DBL_MAX = 1.7976931348623157e308


def _dec(s, dtype="<f8"):
    return np.frombuffer(base64.b64decode(s), dtype=dtype)


def _solve_request(A, AL, AU, l, u, c, obj_constant=0.0, **params):
    A = sp.csr_matrix(A)
    return {
        "op": "solve", "m": A.shape[0], "n": A.shape[1],
        "Ap": _enc(A.indptr.astype(np.int64)),
        "Ai": _enc(A.indices.astype(np.int64)),
        "Ax": _enc(A.data.astype(np.float64)),
        "AL": _enc(np.asarray(AL, np.float64)),
        "AU": _enc(np.asarray(AU, np.float64)),
        "l": _enc(np.asarray(l, np.float64)),
        "u": _enc(np.asarray(u, np.float64)),
        "c": _enc(np.asarray(c, np.float64)),
        "obj_constant": obj_constant, "params": params,
    }


def _demo_request(**params):
    """The JAX server tests' demo request (tests/test_server.py)."""
    return _solve_request(np.array([[1.0, 2.0], [3.0, 1.0]]),
                          [-1e30, -1e30], [10.0, 12.0], np.zeros(2),
                          [1e30, 1e30], [-3.0, -5.0],
                          **{"precision": "f64", "stop_tol": 1e-6,
                             **params})


def _random_request(seed, **params):
    p = jax_random_lp(seed)
    return _solve_request(p.A, p.AL, p.AU, p.l, p.u, p.c,
                          obj_constant=1.5, **params)


def _batched_request(**params):
    """tests/test_server.py's batched request."""
    rng = np.random.default_rng(0)
    m, n, B = 6, 9, 4
    A = sp.random(m, n, density=0.5, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x0 = rng.uniform(-1, 1, (n, B))
    Ax = A @ x0
    return {
        "op": "solve_batched", "m": m, "n": n, "batch": B,
        "Ap": _enc(A.indptr.astype(np.int64)),
        "Ai": _enc(A.indices.astype(np.int64)),
        "Ax": _enc(A.data.astype(np.float64)),
        "C": _enc(rng.normal(size=(n, B)).ravel(order="F")),
        "AL": _enc((Ax - 1.0).ravel(order="F")),
        "AU": _enc((Ax + 1.0).ravel(order="F")),
        "l": _enc((x0 - 2.0).ravel(order="F")),
        "u": _enc((x0 + 2.0).ravel(order="F")),
        "obj_constants": _enc(np.arange(B, dtype=np.float64)),
        "params": {"stop_tol": 1e-4, **params},
    }


def _mps_batched_request():
    """A batched solve over the MPS file's A (the C ABI's MPS route)."""
    B = 2
    col = lambda v: np.tile(np.asarray(v, float)[:, None], (1, B))
    return {"op": "solve_batched", "path": MODEL, "batch": B,
            "C": _enc(col([-3.0, -5.0]).ravel(order="F")),
            "AL": _enc(col([-np.inf, -np.inf]).ravel(order="F")),
            "AU": _enc((col([10.0, 12.0]) * [1.0, 2.0]).ravel(order="F")),
            "l": _enc(col([0.0, 0.0]).ravel(order="F")),
            "u": _enc(col([np.inf, np.inf]).ravel(order="F")),
            "params": {"stop_tol": 1e-6}}


def _infeasible_request():
    """tests/test_server.py's infeasible LP: x0+x1 >= 4 and <= 1."""
    return _solve_request(np.array([[1.0, 1.0], [-1.0, -1.0]]),
                          [4.0, -1.0], [1e30, 1e30], np.zeros(2),
                          [1e30, 1e30], [1.0, 1.0],
                          precision="f64", time_limit=60.0)


SOLVE_CASES = {
    "demo": lambda: _demo_request(),
    "demo_no_presolve": lambda: _demo_request(use_presolve=False),
    "random_lp0": lambda: _random_request(0, stop_tol=1e-6),
    "random_lp3_1e-8": lambda: _random_request(3, stop_tol=1e-8),
    "random_lp5_no_presolve": lambda: _random_request(
        5, stop_tol=1e-6, use_presolve=False),
    "random_lp42_mixed_f64_stages": lambda: _random_request(
        42, stop_tol=1e-8, precision="mixed", refine_stage_precision="f64",
        use_presolve=False),
    "solve_mps": lambda: {"op": "solve_mps", "path": MODEL,
                          "params": {"stop_tol": 1e-6}},
    "solve_mps_no_presolve": lambda: {
        "op": "solve_mps", "path": MODEL,
        "params": {"stop_tol": 1e-8, "use_presolve": False}},
    "infeasible": _infeasible_request,
}


def assert_same_solve(rt, rj):
    assert rt.keys() == rj.keys()
    for k in ("status", "iter", "iter4", "iter6", "iter8"):
        assert rt[k] == rj[k], k
    for k in ("primal_obj", "dual_obj"):
        assert rt[k] == pytest.approx(rj[k], rel=1e-9, abs=1e-12), k
    for k in ("x", "y", "z"):
        assert (rt[k] == "") == (rj[k] == ""), k
        np.testing.assert_allclose(_dec(rt[k]), _dec(rj[k]), rtol=1e-7,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_solve_matches_jax_server(case, libraries):
    req = SOLVE_CASES[case]()
    rt, rj = handle(req, device="cpu"), jserver.handle(req)
    assert rt["ok"] and rj["ok"], (rt, rj)
    assert_same_solve(rt["result"], rj["result"])
    if case != "infeasible":
        assert rt["result"]["status"] == "OPTIMAL"
    if case.startswith(("demo", "solve_mps")):
        assert rt["result"]["primal_obj"] == pytest.approx(-26.4, abs=1e-3)


def test_infeasible_response_travels_as_standard_json(libraries):
    """An unconverged solve's Inf diagnostics become the +-DBL_MAX
    sentinels, as the JAX server sends them."""
    r = handle(_infeasible_request(), device="cpu")
    back = json.loads(json.dumps(r, allow_nan=False))["result"]
    assert back["status"] != "OPTIMAL"
    for k in ("residuals", "gap", "primal_obj", "dual_obj"):
        v = back[k]
        assert isinstance(v, float) and v == v and abs(v) <= DBL_MAX
    assert DBL_MAX in (abs(back["residuals"]), abs(back["gap"]))


def test_fin_sentinels_match_jax():
    for v in (float("inf"), float("-inf"), float("nan"), 1.25, -0.0):
        assert repr(tserver._fin(v)) == repr(jserver._fin(v))
    assert tserver._fin(float("-inf")) == -DBL_MAX


@pytest.mark.parametrize("case", ["arrays", "arrays_mixed", "mps_path"])
def test_solve_batched_matches_jax_server(case, libraries):
    """Per-member statuses and iteration counts equal; objectives to 1e-9
    relative, x/y/z to 1e-7.  "mixed" solves without refinement in f64
    on the CPU in both packages."""
    req = (_mps_batched_request() if case == "mps_path" else
           _batched_request(**({"precision": "mixed"}
                               if case == "arrays_mixed" else {})))
    rt, rj = handle(req, device="cpu"), jserver.handle(req)
    assert rt["ok"] and rj["ok"], (rt, rj)
    rt, rj = rt["result"], rj["result"]
    assert rt.keys() == rj.keys()
    for k in ("m", "n", "batch", "status"):
        assert rt[k] == rj[k], k
    assert all(s == "OPTIMAL" for s in rt["status"])
    np.testing.assert_array_equal(_dec(rt["iter"], "<i8"),
                                  _dec(rj["iter"], "<i8"))
    np.testing.assert_allclose(_dec(rt["primal_obj"]), _dec(rj["primal_obj"]),
                               rtol=1e-9, atol=1e-12)
    for k in ("x", "y", "z", "residuals", "gap"):
        assert len(rt[k]) == len(rj[k]), k
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(_dec(rt[k]), _dec(rj[k]), rtol=1e-7,
                                   atol=1e-7, err_msg=k)
    if case == "mps_path":
        np.testing.assert_allclose(_dec(rt["primal_obj"]), [-26.4, -52.8],
                                   rtol=1e-5)


@pytest.mark.parametrize("req", [
    {"op": "ping"},
    {"op": "nope"},
    {},
    {"op": "mps_dims", "path": MODEL},
    {"op": "solve_mps", "path": MODEL, "params": {"bogus": 1}},
    {"op": "solve_mps", "path": "/nonexistent.mps", "params": {}},
    {"op": "solve", "m": 2},
], ids=["ping", "unknown_op", "no_op", "mps_dims", "unknown_parameter",
        "missing_file", "missing_arrays"])
def test_small_requests_answer_as_jax(req, libraries):
    rt, rj = handle(req, device="cpu"), jserver.handle(req)
    assert rt["ok"] == rj["ok"]
    if rt["ok"] or req.get("op") in ("nope", None) or "bogus" in str(req):
        assert rt == rj
    else:
        assert rt["error"].split(":")[0] == rj["error"].split(":")[0]


def test_unknown_parameter_in_solve_answers_as_jax():
    req = _demo_request(bogus=1)
    rt, rj = handle(req, device="cpu"), jserver.handle(req)
    assert rt == rj == {"ok": False,
                        "error": "ValueError: unknown parameter 'bogus'"}


def test_stream_answers_as_jax(libraries):
    """serve_stream on the same lines: a bad JSON line, a solve, the
    shutdown acknowledgement, and nothing after it."""
    lines = [json.dumps({"op": "ping"}), "not json at all", "",
             json.dumps(_demo_request()), json.dumps({"op": "shutdown"}),
             json.dumps({"op": "ping"})]
    outs = []
    for serve, kw in ((tserver.serve_stream, {"device": "cpu"}),
                      (jserver.serve_stream, {})):
        out = io.StringIO()
        serve(io.StringIO("\n".join(lines) + "\n"), out, **kw)
        outs.append([json.loads(x) for x in out.getvalue().splitlines()])
    rt, rj = outs
    assert len(rt) == len(rj) == 4
    assert rt[0] == rj[0] == {"ok": True, "result": "pong"}
    assert rt[1] == rj[1] and not rt[1]["ok"]
    assert rt[1]["error"].startswith("bad json: ")
    assert_same_solve(rt[2]["result"], rj[2]["result"])
    assert rt[3] == rj[3] == {"ok": True}


def test_no_cuda_without_device_cpu_answers_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for req in (_demo_request(), {"op": "solve_mps", "path": MODEL},
                _batched_request()):
        for device in (None, "cuda:0"):
            r = handle(req, device=device)
            assert not r["ok"]
            assert r["error"].startswith("RuntimeError: no CUDA device"), r
    assert handle({"op": "ping"}) == {"ok": True, "result": "pong"}
    assert handle({"op": "mps_dims", "path": MODEL})["ok"]
    assert "no CUDA device" in tserver.device_line(None)
    assert tserver.device_line("cpu") == "device cpu"


# ---------------------------------------------------------------------------
# The transports, in a subprocess
# ---------------------------------------------------------------------------

def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, **extra)
    env.pop("PYTHONSTARTUP", None)
    return env


def _server(*args):
    return [sys.executable, "-m", "hprlp_tpu_torch.server", *args]


def _launches(stderr):
    line = next(x for x in stderr.splitlines()
                if x.startswith("kernel launches "))
    return json.loads(line[len("kernel launches "):])


@pytest.mark.parametrize("verbose", [False, True], ids=["quiet", "verbose"])
def test_pipe_session(verbose, libraries):
    """The C ABI's and Julia's transport: a verbose solve logs to stderr
    only, and the pipe stays in step."""
    p = subprocess.Popen(_server("--device", "cpu"), stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=_env(), text=True)
    try:
        def ask(req):
            p.stdin.write(json.dumps(req) + "\n")
            p.stdin.flush()
            return json.loads(p.stdout.readline())

        assert ask({"op": "ping"}) == {"ok": True, "result": "pong"}
        req = _demo_request(verbose=verbose)
        got = ask(req)
        assert got["ok"] and got["result"]["status"] == "OPTIMAL"
        assert_same_solve(got["result"], jserver.handle(req)["result"])
        p.stdin.write("not json\n\n")
        p.stdin.flush()
        assert not json.loads(p.stdout.readline())["ok"]
        assert ask(_batched_request())["result"]["batch"] == 4
        assert ask({"op": "shutdown"}) == {"ok": True}
        assert p.wait(timeout=60) == 0
        assert p.stdout.read() == ""
        err = p.stderr.read()
        assert err.splitlines()[0] == "device cpu"
        assert ("iter" in err) == verbose
        assert _launches(err) == {"tiled_spmv": 0, "tiled_x_half": 0,
                                  "tiled_y_half": 0,
                                  "tiled_half_epilogue": 0, "csr_spmv": 0,
                                  "spmv_x_half": 0, "spmv_y_half": 0,
                                  "csr_spmm": 0, "spmm_x_half": 0,
                                  "spmm_y_half": 0}
    finally:
        if p.poll() is None:
            p.kill()


@pytest.mark.parametrize("to_file", [True, False],
                         ids=["response_file", "response_stdout"])
def test_oneshot_files(tmp_path, to_file, libraries):
    """The MATLAB wrapper's one-shot transport."""
    req = _demo_request()
    (tmp_path / "req.json").write_text(json.dumps(req))
    resp = tmp_path / "resp.json"
    args = ["--device", "cpu", "--request", str(tmp_path / "req.json")]
    r = subprocess.run(_server(*args, *(["--response", str(resp)]
                                        if to_file else [])),
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(resp.read_text() if to_file else r.stdout)
    assert got["ok"]
    assert_same_solve(got["result"], jserver.handle(req)["result"])
    assert r.stdout == ("" if to_file else json.dumps(got) + "\n")


def test_oneshot_error_exits_1(tmp_path):
    (tmp_path / "req.json").write_text(json.dumps({"op": "nope"}))
    r = subprocess.run(_server("--device", "cpu", "--request",
                               str(tmp_path / "req.json"), "--response",
                               str(tmp_path / "resp.json")),
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 1
    assert json.loads((tmp_path / "resp.json").read_text()) == {
        "ok": False, "error": "unknown op 'nope'"}


def test_watch_dir_transport(tmp_path, libraries):
    """The warm MATLAB/Octave transport: <id>.req.json in, <id>.resp.json
    out, shutdown.req.json stops the server."""
    wdir = tmp_path / "watch"
    wdir.mkdir()
    proc = subprocess.Popen(
        _server("--device", "cpu", "--watch", str(wdir), "--idle-timeout",
                "120"),
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        def ask(rid, req):
            tmp = wdir / f"{rid}.tmp"
            tmp.write_text(json.dumps(req))
            tmp.rename(wdir / f"{rid}.req.json")
            resp_p = wdir / f"{rid}.resp.json"
            deadline = time.time() + 120
            while time.time() < deadline:
                if resp_p.exists():
                    out = json.loads(resp_p.read_text())
                    resp_p.unlink()
                    return out
                time.sleep(0.02)
            raise TimeoutError("no response")

        assert ask("a1", {"op": "ping"}) == {"ok": True, "result": "pong"}
        req = {"op": "solve_mps", "path": MODEL,
               "params": {"stop_tol": 1e-6}}
        r = ask("a2", req)
        assert r["ok"], r
        assert_same_solve(r["result"], jserver.handle(req)["result"])
        assert not ask("a3", {"op": "nope"})["ok"]
        (wdir / "shutdown.tmp").write_text("{}")
        (wdir / "shutdown.tmp").rename(wdir / "shutdown.req.json")
        assert proc.wait(timeout=60) == 0
        assert sorted(os.listdir(wdir)) == []
        assert proc.stdout.read() == ""
        assert proc.stderr.read().splitlines()[0] == "device cpu"
    finally:
        if proc.poll() is None:
            proc.kill()


def test_no_cuda_default_device_answers_an_error():
    """Without --device and without a visible CUDA device, a solve request
    answers the error; the server never solves on the CPU unasked."""
    p = subprocess.run(_server(), input=json.dumps(_demo_request()) + "\n",
                       env=_env(CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout)
    assert not got["ok"]
    assert got["error"].startswith("RuntimeError: no CUDA device")
    assert p.stderr.splitlines()[0].startswith(
        "device cuda:0 (no CUDA device available")


def test_protocol_owns_file_descriptor_1():
    """After the server takes the protocol's stream, Python prints, raw
    writes to fd 1 and child processes all land on stderr."""
    code = ("import os, subprocess, sys\n"
            "from hprlp_tpu_torch.server import _protocol_stdout\n"
            "proto = _protocol_stdout()\n"
            "print('printed')\n"
            "os.write(1, b'raw\\n')\n"
            "subprocess.run(['sh', '-c', 'echo child'])\n"
            "proto.write('response\\n'); proto.flush()\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "response\n"
    assert r.stderr.split() == ["printed", "raw", "child"]


def test_module_help_names_the_device_flag():
    r = subprocess.run(_server("--help"), env=_env(), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and "--device" in r.stdout
    r = subprocess.run(_server("--device", "gpu"), env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "CUDA device index or 'cpu'" in r.stderr
