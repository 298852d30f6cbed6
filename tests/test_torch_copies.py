"""Pins the port's copies of JAX-package code to their originals, and the
port's import boundary (no JAX, no hprlp_tpu, no Triton at import)."""

import ast
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import hprlp_tpu.constants as jconst
import hprlp_tpu.params as jparams
import hprlp_tpu.problem as jproblem
import hprlp_tpu.results as jresults
import hprlp_tpu_torch.constants as tconst
import hprlp_tpu_torch.params as tparams
import hprlp_tpu_torch.problem as tproblem
import hprlp_tpu_torch.results as tresults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "hprlp_tpu_torch")


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        out.append((f.name, f.type, repr(default)))
    return out


@pytest.mark.parametrize("pair", [
    (jparams.Parameters, tparams.Parameters),
    (jresults.Results, tresults.Results),
    (jresults.BatchedResults, tresults.BatchedResults),
    (jproblem.LpProblem, tproblem.LpProblem),
], ids=["Parameters", "Results", "BatchedResults", "LpProblem"])
def test_dataclass_copies_match(pair):
    assert _fields(pair[1]) == _fields(pair[0])


def test_parameters_validate_matches():
    for kw in ({}, {"spmv_backend": "xla"}, {"precision": "bad"},
               {"check_iter": 1}, {"stop_tol": 0.0},
               {"refine_stage_precision": "f16"}):
        outs = []
        for P in (jparams.Parameters, tparams.Parameters):
            p = P(**kw)
            try:
                p.validate()
                outs.append(("ok", p.spmv_backend))
            except ValueError as e:
                outs.append(("err", str(e)))
        assert outs[0] == outs[1], kw


def test_constants_match():
    names = [n for n in vars(tconst) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


def test_lp_problem_behaviour_matches():
    rng = np.random.default_rng(3)
    A = sp.random(20, 30, density=0.3, random_state=rng).tocsr()
    x = rng.uniform(-1, 1, 30)
    args = (A, A @ x - 1, np.full(20, 1e21), x - 1, x + 1,
            rng.normal(size=30))
    pj = jproblem.LpProblem.from_arrays(*args, obj_constant=2.0)
    pt = tproblem.LpProblem.from_arrays(*args, obj_constant=2.0)
    for k in ("AL", "AU", "l", "u", "c"):
        np.testing.assert_array_equal(getattr(pt, k), getattr(pj, k))
    assert (pt.A != pj.A).nnz == 0
    z = rng.normal(size=30)
    for y in (rng.normal(size=20), np.abs(rng.normal(size=20))):
        np.testing.assert_equal(pt.kkt_error(x, y, z), pj.kkt_error(x, y, z))
    with pytest.raises(ValueError, match="AL > AU"):
        tproblem.LpProblem.from_arrays(A, np.ones(20), np.zeros(20),
                                       x - 1, x + 1, np.ones(30))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_py_function(name):
    """benchmarks/run.py's generator, taken from its source (importing the
    script would reconfigure JAX's compile cache for this process)."""
    with open(os.path.join(ROOT, "benchmarks", "run.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"np": np, "sp": sp, "LpProblem": jproblem.LpProblem}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "run.py", "exec"),
         ns)
    return ns[name]


@pytest.mark.parametrize("name,args", [
    ("random_lp", (300, 500, 7, 2)),
    ("assignment_problem", (8,)),
])
def test_chip_smoke_generators_match_benchmarks(name, args):
    pj = _run_py_function(name)(*args)
    pt = getattr(_load_chip_smoke(), name)(*args)
    assert pt.name == pj.name
    assert (pt.A != pj.A).nnz == 0
    for k in ("AL", "AU", "l", "u", "c"):
        np.testing.assert_array_equal(getattr(pt, k), getattr(pj, k))


@pytest.mark.parametrize("name,args", [
    ("random_lp", (300, 500, 7, 2)),
    ("banded_lp", (300, 600, 9, 20, 5)),
    ("assignment_problem", (8,)),
    ("make_problem", ()),
])
def test_prof_problem_generators_match_originals(name, args, monkeypatch):
    """hprlp_tpu_torch/prof/problems.py against benchmarks/run.py and
    bench.py (make_problem at a cut size, with the same constants)."""
    import bench

    import hprlp_tpu_torch.prof.problems as tprob

    if name == "make_problem":
        assert (tprob.M, tprob.N, tprob.NNZ_PER_ROW, tprob.SEED) == \
            (bench.M, bench.N, bench.NNZ_PER_ROW, bench.SEED)
        for mod in (bench, tprob):
            monkeypatch.setattr(mod, "M", 300)
            monkeypatch.setattr(mod, "N", 500)
        pj = bench.make_problem()
    else:
        pj = _run_py_function(name)(*args)
    pt = getattr(tprob, name)(*args)
    assert pt.name == pj.name
    assert pt.A.shape == pj.A.shape and (pt.A != pj.A).nnz == 0
    for k in ("AL", "AU", "l", "u", "c"):
        np.testing.assert_array_equal(getattr(pt, k), getattr(pj, k))


class _Captured(Exception):
    pass


def test_batched_lp_copy_matches_run_batched():
    """prof/problems.py::batched_lp against the generator inside
    benchmarks/run.py::run_batched, whose solve_batched call is replaced by
    one that records its arguments."""
    import time

    import hprlp_tpu_torch.prof.problems as tprob

    got = {}

    def record(*args, **kw):
        got["args"] = args
        raise _Captured

    with open(os.path.join(ROOT, "benchmarks", "run.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_batched")
    ns = {"np": np, "sp": sp, "time": time, "solve_batched": record,
          "Parameters": lambda **kw: kw}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "run.py", "exec"),
         ns)
    with pytest.raises(_Captured):
        ns["run_batched"](40, 70, 5, 3, 1e-4, 10.0)
    want = got["args"]
    have = tprob.batched_lp(40, 70, 5, 3)
    assert len(have) == len(want) == 6
    assert (have[0] != want[0]).nnz == 0
    for a, b in zip(have[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def _body_without_docstring(path, drop=()):
    """ast.dump of a module's statements after its docstring, without the
    top-level functions or class methods named in `drop`."""
    with open(path) as f:
        tree = ast.parse(f.read())
    body = tree.body[1:] if isinstance(tree.body[0], ast.Expr) else tree.body
    out = []
    for node in body:
        if isinstance(node, ast.FunctionDef) and node.name in drop:
            continue
        if isinstance(node, ast.ClassDef):
            node.body = [n for n in node.body if not (
                isinstance(n, ast.FunctionDef)
                and f"{node.name}.{n.name}" in drop)]
        out.append(ast.dump(node))
    return out


@pytest.mark.parametrize("copy,original,drop", [
    ("io/mps.py", "hprlp_tpu/io/mps.py", ()),
    # The port's ModelBuilder.solve takes a torch device.
    ("modeling.py", "hprlp_tpu/modeling.py", ("ModelBuilder.solve",)),
    ("_malloc.py", "hprlp_tpu/_malloc.py", ()),
], ids=["io.mps", "modeling", "_malloc"])
def test_module_copies_match(copy, original, drop):
    assert _body_without_docstring(os.path.join(PORT, copy), drop) == \
        _body_without_docstring(os.path.join(ROOT, original), drop)


def _function(path, name):
    with open(path) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def test_structured_lp_copy_matches():
    """prof/problems.py::structured_lp against
    benchmarks/prof_presolve_scale.py's, taken from its source (importing
    that script tunes the process's allocator): the same code, and the
    same LP at a cut scale."""
    import hprlp_tpu_torch.prof.problems as tprob

    orig = _function(os.path.join(ROOT, "benchmarks",
                                  "prof_presolve_scale.py"), "structured_lp")
    assert ast.dump(_function(tprob.__file__, "structured_lp")) == \
        ast.dump(orig)
    ns = {"np": np, "sp": sp, "LpProblem": jproblem.LpProblem,
          "INF": float("inf")}
    exec(compile(ast.Module(body=[orig], type_ignores=[]),
                 "prof_presolve_scale.py", "exec"), ns)
    pj = ns["structured_lp"](scale=0.002, seed=7)
    pt = tprob.structured_lp(scale=0.002, seed=7)
    assert pt.name == pj.name and (pt.A != pj.A).nnz == 0
    for k in ("AL", "AU", "l", "u", "c"):
        np.testing.assert_array_equal(getattr(pt, k), getattr(pj, k))


class _Recorder:
    """Stands in for a ctypes library: records each function's
    argtypes and restype."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("Fn", (), {})())


def test_native_signatures_match():
    """native.py binds hprlp_tpu/native.py's hpres_* presolve and hpmps_*
    reader signatures (52-82, 132-153) and its hprlp_parallel_touch
    (100-101, which _malloc.preheat calls), and none of its lane/scaling
    entry points."""
    import hprlp_tpu.native as jnative
    import hprlp_tpu_torch.native as tnative

    port, jax = _Recorder(), _Recorder()
    tnative._configure(port)
    jnative._configure(jax)
    lane = ("hpres_lane_schedule", "hpres_lane_pack_thin",
            "hpres_balance_cells")
    want = {k for k in jax.fns if k.startswith(("hpres_", "hpmps_"))
            and k not in lane} | {"hprlp_parallel_touch"}
    assert set(port.fns) == want
    for name in want:
        for attr in ("argtypes", "restype"):
            assert getattr(port.fns[name], attr) == \
                getattr(jax.fns[name], attr), (name, attr)


def test_import_leaves_out_jax_triton_and_the_jax_package():
    code = ("import sys, hprlp_tpu_torch, hprlp_tpu_torch.convert, "
            "hprlp_tpu_torch.ops.spmv, hprlp_tpu_torch.solver.loop, "
            "hprlp_tpu_torch.cli, hprlp_tpu_torch.model, "
            "hprlp_tpu_torch.presolve, hprlp_tpu_torch.io.mps, "
            "hprlp_tpu_torch.io.native_mps, hprlp_tpu_torch.modeling, "
            "hprlp_tpu_torch.native, hprlp_tpu_torch.prof.problems, "
            "hprlp_tpu_torch.ops.spmv_variants, "
            "hprlp_tpu_torch.prof.prof_lane_ablate, "
            "hprlp_tpu_torch.prof.prof_dual_acc, "
            "hprlp_tpu_torch.prof.prof_flush_variants, "
            "hprlp_tpu_torch.prof.prof_kernel_variants, "
            "hprlp_tpu_torch.ops.spmm, hprlp_tpu_torch.solver.batched, "
            "hprlp_tpu_torch.solver.batched_device_loop, "
            "hprlp_tpu_torch.prof.prof_loop, "
            "hprlp_tpu_torch.prof.prof_ynew_store, hprlp_tpu_torch.server, "
            "hprlp_tpu_torch.capi, hprlp_tpu_torch.solver.refine, "
            "hprlp_tpu_torch._malloc, hprlp_tpu_torch.prof.share_ingest, "
            "hprlp_tpu_torch.prof.prof_epilogue, "
            "hprlp_tpu_torch.prof.prof_mixed; "
            "bad = [m for m in ('jax', 'triton', 'hprlp_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "hprlp_tpu"), (path, mod)
