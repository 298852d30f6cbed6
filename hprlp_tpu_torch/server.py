"""Persistent solver server of the PyTorch port: the line-delimited JSON
protocol of hprlp_tpu/server.py, with base64 array transport, served by
hprlp_tpu_torch on a CUDA device.

    python -m hprlp_tpu_torch.server [--device N|cpu]
        [--request FILE [--response FILE] | --watch DIR [--idle-timeout S]]

The C ABI (native/src/hprlp_c_api.cpp), Julia and MATLAB start
"$HPRLP_TPU_PYTHON -m hprlp_tpu.server"; capi.write_launcher writes a
launcher for HPRLP_TPU_PYTHON that starts this module in its place, so
those callers drive the port unchanged.

Transport (the JAX server's three):
  * default: requests on stdin, responses on stdout, one JSON object per
    line (binary arrays as base64 of little-endian raw bytes; float64,
    int64 for index arrays);
  * --request FILE --response FILE: serve exactly one request;
  * --watch DIR: serve <id>.req.json files dropped in DIR (the MATLAB and
    Octave wrapper's warm transport).

Operations: ping, shutdown, mps_dims, solve_mps, solve, solve_batched
(with "path" or CSR arrays), with the JAX server's keys and responses;
non-finite scalars travel as +-DBL_MAX (_fin).

--device takes a CUDA device index or "cpu", as the CLI's does.  Without
it each solve runs on cuda:{params.device_number}; without CUDA a solve
request answers an error and never runs on the CPU unasked.  A request
whose params set mesh_shape=N launches N ranks for its solve, as
Model.solve does without a process group (cards 0..N-1, or gloo ranks
with --device cpu), and writes their start seconds to stderr.  At start the
server writes one line to stderr naming its device, and at exit one line
with its kernels' launch counts.  Between requests it hands the CUDA
caching allocator's free blocks back to CUDA, so a warm worker holds no
solve's memory while it waits.
"""

from __future__ import annotations

import base64
import gc
import json
import os
import sys

import numpy as np


def _enc(a: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(a).tobytes()).decode("ascii")


def _dec_f64(s: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype="<f8").copy()


def _dec_i64(s: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype="<i8").copy()


def _params(d: dict):
    from .params import Parameters

    p = Parameters(verbose=False)
    for k, v in (d or {}).items():
        if not hasattr(p, k):
            raise ValueError(f"unknown parameter {k!r}")
        setattr(p, k, v)
    return p


def _fin(v: float) -> float:
    """JSON has no Infinity/NaN tokens (json.dumps would emit the
    non-standard `Infinity`, which the Julia/MATLAB parsers reject), so
    non-finite diagnostics travel as +-DBL_MAX; wrappers map magnitudes
    >= 1e307 back to Inf."""
    v = float(v)
    if v != v:  # NaN reads as "no usable value": overflow sentinel too
        return 1.7976931348623157e308
    if v == float("inf"):
        return 1.7976931348623157e308
    if v == float("-inf"):
        return -1.7976931348623157e308
    return v


def _pack_results(res) -> dict:
    out = {
        "status": res.status, "iter": int(res.iter),
        "time": _fin(res.time), "primal_obj": _fin(res.primal_obj),
        "dual_obj": _fin(res.dual_obj), "gap": _fin(res.gap),
        "residuals": _fin(res.residuals),
        "iter4": int(res.iter4), "iter6": int(res.iter6),
        "iter8": int(res.iter8), "time4": _fin(res.time4),
        "time6": _fin(res.time6), "time8": _fin(res.time8),
    }
    for k in ("x", "y", "z"):
        v = getattr(res, k)
        out[k] = _enc(np.asarray(v, np.float64)) if v is not None else ""
    return out


def _csr(req: dict):
    import scipy.sparse as sp

    m, n = int(req["m"]), int(req["n"])
    return sp.csr_matrix((_dec_f64(req["Ax"]),
                          _dec_i64(req["Ai"]).astype(np.int32),
                          _dec_i64(req["Ap"])), shape=(m, n))


def solve_device(params, device=None):
    """The torch device a solve runs on: `device`, or
    cuda:{params.device_number} when it is None.  Raises RuntimeError when
    that is a CUDA device and there is none."""
    import torch

    from .solver.loop import resolve_device

    dev = resolve_device(params, device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; start the server "
                           "with --device cpu to solve on the CPU")
    return dev


def handle(req: dict, device=None) -> dict:
    """Dispatch one request; ANY failure returns an error response (the
    error boundary lives here so every transport shares it).  device: as
    solve_device's."""
    try:
        return _handle(req, device)
    except Exception as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def _handle(req: dict, device) -> dict:
    op = req.get("op")
    if op == "ping":
        return {"ok": True, "result": "pong"}

    if op == "mps_dims":
        from .model import Model

        model = Model.from_mps(req["path"],
                               mps_format=req.get("mps_format", "free"))
        return {"ok": True, "result": {"m": model.m, "n": model.n,
                                       "nnz": model.nnz}}

    if op not in ("solve_mps", "solve", "solve_batched"):
        return {"ok": False, "error": f"unknown op {op!r}"}
    params = _params(req.get("params"))
    dev = solve_device(params, device)

    if op == "solve_mps":
        from .model import Model

        model = Model.from_mps(req["path"],
                               mps_format=req.get("mps_format", "free"))
        res = _mesh_noted(params, lambda: model.solve(params, device=dev))
        return {"ok": True, "result": _pack_results(res)}

    if op == "solve":
        from .model import Model

        model = Model.from_arrays(
            _csr(req), _dec_f64(req["AL"]), _dec_f64(req["AU"]),
            _dec_f64(req["l"]), _dec_f64(req["u"]), _dec_f64(req["c"]),
            obj_constant=float(req.get("obj_constant", 0.0)))
        res = _mesh_noted(params, lambda: model.solve(params, device=dev))
        return {"ok": True, "result": _pack_results(res)}

    from .solver.batched import solve_batched

    B = int(req["batch"])
    if req.get("path"):
        # MPS-backed model: reuse its A only (solve_batched ignores the
        # model's vectors, as the JAX server's does).
        from .model import Model

        A = Model.from_mps(req["path"],
                           mps_format=req.get("mps_format", "free")
                           ).problem.A.tocsr()
    else:
        A = _csr(req)
    m, n = A.shape

    def mat(key, rows):
        return _dec_f64(req[key]).reshape(rows, B, order="F")

    oc = (_dec_f64(req["obj_constants"])
          if req.get("obj_constants") else None)
    res = _mesh_noted(params, lambda: solve_batched(
        A, mat("C", n), mat("AL", m), mat("AU", m), mat("l", n),
        mat("u", n), obj_constants=oc, params=params, device=dev))
    out = {
        "m": res.m, "n": res.n, "batch": res.batch_size,
        "status": list(res.status),
        "iter": _enc(np.asarray(res.iter, np.int64)),
        "residuals": _enc(np.asarray(res.residuals, np.float64)),
        "gap": _enc(np.asarray(res.gap, np.float64)),
        "primal_obj": _enc(np.asarray(res.primal_obj, np.float64)),
        "x": _enc(np.asarray(res.x, np.float64).ravel(order="F")),
        "y": _enc(np.asarray(res.y, np.float64).ravel(order="F")),
        "z": _enc(np.asarray(res.z, np.float64).ravel(order="F")),
        "time": float(res.time), "setup_time": float(res.setup_time),
        "solve_time": float(res.solve_time),
        "power_time": float(res.power_time),
    }
    return {"ok": True, "result": out}


def _mesh_noted(params, solve):
    """solve(); with params.mesh_shape, which launches that many ranks
    (parallel/distributed.py::launch), one stderr line with the ranks'
    seconds from their start to their group being up."""
    out = solve()
    if params.mesh_shape:
        from .parallel import distributed

        rec = distributed.launch.record
        print(f"mesh of {rec['world']} ranks: groups up in "
              + ", ".join(f"{s:.3f}" for s in rec["start_s"])
              + f" s, launch wall {rec['wall_s']:.3f} s",
              file=sys.stderr, flush=True)
    return out


def release_device_memory() -> None:
    """Drop what the last request left to the garbage collector (a
    solve's CUDA graph among it) and the graph pool its captures shared
    (solver/graph.py::release_graph_pools), free the cuBLAS workspaces
    (PyTorch keeps one per stream) and hand the caching allocator's free
    blocks back to CUDA."""
    import torch

    from .solver.graph import release_graph_pools

    release_graph_pools()
    gc.collect()
    if torch.cuda.is_initialized():
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()


def serve_stream(inp, outp, device=None) -> None:
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            outp.write(json.dumps({"ok": False,
                                   "error": f"bad json: {e}"}) + "\n")
            outp.flush()
            continue
        if req.get("op") == "shutdown":
            try:
                outp.write(json.dumps({"ok": True}) + "\n")
                outp.flush()
            except (BrokenPipeError, ValueError):
                pass  # client already hung up
            return
        resp = handle(req, device)
        try:
            # Standard JSON only: a stray non-finite float must become a
            # clean error response, not an `Infinity` token the wrapper
            # parsers reject (scalars are sanitised in _pack_results).
            text = json.dumps(resp, allow_nan=False)
        except ValueError as e:
            text = json.dumps({"ok": False,
                               "error": f"non-finite in response: {e}"})
        del resp
        release_device_memory()
        outp.write(text + "\n")
        outp.flush()


def serve_watch_dir(watch_dir: str, idle_timeout: float = 1800.0,
                    device=None) -> None:
    """Warm request-directory transport (the MATLAB/Octave wrapper's
    persistent server).  Clients atomically rename a JSON request into
    `<id>.req.json`; the server handles it, atomically renames the
    response into `<id>.resp.json` and deletes the request.  A file named
    `shutdown.req.json` stops the server.  The server also exits after
    idle_timeout seconds without requests, or when the directory
    disappears (client session ended)."""
    import time

    last = time.monotonic()
    while True:
        try:
            names = sorted(os.listdir(watch_dir))
        except OSError:
            return  # directory removed: client session is gone
        served = False
        for name in names:
            if not name.endswith(".req.json"):
                continue
            path = os.path.join(watch_dir, name)
            if name == "shutdown.req.json":
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return
            try:
                with open(path) as f:
                    req = json.load(f)
            except (OSError, ValueError):
                continue  # mid-rename or unreadable: retry next scan
            resp = handle(req, device)
            release_device_memory()
            out = path[:-len(".req.json")] + ".resp.json"
            tmp = out + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps(resp))
            os.replace(tmp, out)  # atomic: clients never see partials
            try:
                os.unlink(path)
            except OSError:
                pass
            served = True
        now = time.monotonic()
        if served:
            last = now
        elif now - last > idle_timeout:
            return
        else:
            time.sleep(0.05)


def device_line(device) -> str:
    """The startup line naming the server's device."""
    import torch

    from .params import Parameters

    dev = torch.device(device if device is not None
                       else f"cuda:{Parameters().device_number}")
    if dev.type != "cuda":
        return f"device {dev}"
    if not torch.cuda.is_available():
        return (f"device {dev} (no CUDA device available: solve requests "
                f"answer an error)")
    return f"device {dev} ({torch.cuda.get_device_name(dev)})"


def launch_counts() -> dict:
    """Launches of each hand-written kernel in this process, by wrapper
    (their plain versions on the CPU count none)."""
    from .ops.spmm import csr_spmm, spmm_x_half, spmm_y_half
    from .ops.spmv import (csr_spmv, spmv_x_half, spmv_y_half,
                           tiled_half_epilogue, tiled_spmv, tiled_x_half,
                           tiled_y_half)

    return {f.__name__: f.launches for f in (
        tiled_spmv, tiled_x_half, tiled_y_half, tiled_half_epilogue,
        csr_spmv, spmv_x_half, spmv_y_half, csr_spmm, spmm_x_half,
        spmm_y_half)}


def _protocol_stdout():
    """Move the protocol to a private duplicate of file descriptor 1 and
    point fd 1 at fd 2, so that nothing else -- a verbose solve's log, a
    compiler started at first use, a C library -- can write a stray line
    into the responses.  Returns the protocol's text stream."""
    proto = os.fdopen(os.dup(1), "w")
    sys.stdout.flush()
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    return proto


def main(argv=None) -> int:
    import argparse

    from .cli import _device

    ap = argparse.ArgumentParser(prog="hprlp-server")
    ap.add_argument("--device", type=_device, default=None,
                    help="CUDA device index, or 'cpu' (default: "
                         "cuda:{params.device_number} of each request)")
    ap.add_argument("--request", default=None,
                    help="serve ONE request from this JSON file")
    ap.add_argument("--response", default=None,
                    help="write the one-shot response to this JSON file")
    ap.add_argument("--watch", default=None, metavar="DIR",
                    help="serve <id>.req.json files dropped in DIR until "
                         "shutdown.req.json arrives or DIR disappears "
                         "(the warm MATLAB/Octave transport)")
    ap.add_argument("--idle-timeout", type=float, default=1800.0,
                    help="with --watch: exit after this many seconds "
                         "without requests")
    args = ap.parse_args(argv)
    device = (None if args.device is None else
              "cpu" if args.device == "cpu" else f"cuda:{args.device}")

    proto_out = _protocol_stdout()
    print(device_line(device), file=sys.stderr, flush=True)
    try:
        if args.watch:
            serve_watch_dir(args.watch, args.idle_timeout, device)
            return 0
        if args.request:
            with open(args.request) as f:
                req = json.load(f)
            resp = handle(req, device)
            text = json.dumps(resp)
            if args.response:
                with open(args.response, "w") as f:
                    f.write(text)
            else:
                proto_out.write(text + "\n")
                proto_out.flush()
            return 0 if resp.get("ok") else 1
        serve_stream(sys.stdin, proto_out, device)
        return 0
    finally:
        print("kernel launches " + json.dumps(launch_counts()),
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    sys.exit(main())
