"""The port's CLI (hprlp_tpu_torch.cli, --device cpu) against the JAX
package's (hprlp_tpu.cli) on the same MPS files: the same exit codes and
solution files (status and iteration count equal, objectives to 1e-9
relative, x, y, z to 1e-7), and the port's messages for the flags whose
feature it lacks."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import hprlp_tpu.cli as jcli
from hprlp_tpu_torch import cli
from hprlp_tpu_torch.problem import LpProblem

from conftest import random_lp as jax_random_lp
from test_torch_mps import _parse_error
from test_torch_model_mps import FILES, _arrays_lp
from test_torch_presolve import libraries  # noqa: F401 (a fixture)

# The tensors here are small: one intra-op thread keeps this test worker
# from competing with the suite's other workers for cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "data", "model.mps")


def read_solution(path):
    """cli.write_solution's file as ({key: value}, {"x"|"y"|"z": array}).
    A value written as `np.float64(v)` (the JAX package's objectives with
    presolve off are numpy scalars, whose repr says so) is read as v."""
    with open(path) as f:
        lines = f.read().splitlines()
    head, vecs, k = {}, {}, 0
    while k < len(lines):
        key, val = lines[k].split(" ", 1)
        k += 1
        if key in ("x", "y", "z"):
            vecs[key] = np.array(lines[k:k + int(val)], dtype=np.float64)
            k += int(val)
        else:
            head[key] = re.sub(r"^np\.float64\((.*)\)$", r"\1", val)
    return head, vecs


def summary(line):
    """The --quiet line as {key: value}, without the time it took."""
    fields = dict(f.split("=", 1) for f in line.split())
    del fields["time"]
    return fields


def run_both(tmp_path, args):
    """(rc, head, vecs) of the port's CLI on the CPU and of the JAX
    package's, each writing its own solution file."""
    out = []
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        sol = os.path.join(tmp_path, f"{name}.sol")
        rc = main([*args, "--quiet", "--solution-out", sol, *extra])
        out.append((rc, *(read_solution(sol) if os.path.exists(sol)
                          else ({}, {}))))
    return out


def assert_same_solution(got, want, obj_rel=1e-9, vec_tol=1e-7):
    (rc_t, head_t, vec_t), (rc_j, head_j, vec_j) = got, want
    assert rc_t == rc_j
    assert head_t["status"] == head_j["status"]
    assert head_t["iter"] == head_j["iter"]
    for k in ("primal_obj", "dual_obj"):
        assert float(head_t[k]) == pytest.approx(float(head_j[k]),
                                                 rel=obj_rel, abs=1e-12), k
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(vec_t[k], vec_j[k], rtol=vec_tol,
                                   atol=vec_tol, err_msg=k)


def _random_lp_file(tmp_path):
    from hprlp_tpu_torch.prof.problems import write_mps

    p = jax_random_lp(1)
    path = os.path.join(tmp_path, "random_lp1.mps")
    write_mps(LpProblem.from_arrays(p.A, p.AL, p.AU, p.l, p.u, p.c), path)
    return path


# name -> (path maker, extra CLI arguments, exit code)
SOLVES = {
    "model": (lambda t: MODEL, [], 0),
    "model_no_presolve": (lambda t: MODEL, ["--presolve", "false"], 0),
    "model_no_scaling": (lambda t: MODEL, ["--cr", "false", "--ruiz", "false",
                                           "--pock", "false", "--bc", "false"],
                         0),
    "random_lp1": (_random_lp_file, ["--tol", "1e-6", "--check-iter", "100"],
                   0),
    "structured_lp": (FILES["structured_lp_2e-4"][0], [], 0),
    "fixed_format": (FILES["fixed_names.mps"][0], ["--mps-format", "fixed"],
                     0),
    "iter_limit": (_random_lp_file, ["--max-iter", "60"], 2),
    "infeasible_by_presolve": (_arrays_lp("infeasible"), [], 2),
    "reduced_to_nothing": (_arrays_lp("forcing_row"), [], 0),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_cli_matches_jax(tmp_path, case, libraries, capsys):
    make, extra, rc = SOLVES[case]
    got, want = run_both(tmp_path, ["-i", make(tmp_path), *extra])
    assert got[0] == rc
    # A point the solve stopped at after 60 iterations is held to 1e-6
    # (objective) and 1e-5 (x, y, z): rounding differences between the two
    # packages' reductions have not been damped out there.
    tol = (1e-6, 1e-5) if case == "iter_limit" else (1e-9, 1e-7)
    assert_same_solution(got, want, *tol)
    lines = [summary(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("status=")]
    assert len(lines) == 2
    obj_t, obj_j = (float(line.pop("obj")) for line in lines)
    assert lines[0] == lines[1]
    assert obj_t == pytest.approx(obj_j, rel=tol[0])


@pytest.mark.parametrize("case", ["missing", "parse_error"])
def test_input_errors_exit_1_as_jax(tmp_path, case, libraries, capsys):
    path = (os.path.join(tmp_path, "absent.mps") if case == "missing"
            else _parse_error(tmp_path))
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        assert main(["-i", path, "--quiet", *extra]) == 1
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1]


def test_mesh_flag_parses_as_jax():
    """--mesh N: the JAX CLI's flag and default (N ranks here; the CPU
    run is tests/test_torch_parallel_ranks.py's)."""
    for argv in (["-i", "f"], ["-i", "f", "--mesh", "4"]):
        assert (cli.build_parser().parse_args(argv).mesh
                == jcli.build_parser().parse_args(argv).mesh)
    assert cli.params_from_args(cli.build_parser().parse_args(
        ["-i", "f", "--mesh", "4"])).mesh_shape == 4


@pytest.mark.parametrize("flags,name", [
    (["--malloc-tune"], "--malloc-tune"),
], ids=["malloc_tune"])
def test_unported_flags_exit_1(flags, name, capsys):
    assert cli.main(["-i", MODEL, "--device", "cpu", *flags]) == 1
    captured = capsys.readouterr()
    assert "Not ported to hprlp_tpu_torch yet" in captured.err
    assert name in captured.err and captured.out == ""


def test_no_cuda_without_device_cpu_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-i", MODEL, "--quiet"]) == 1
    assert "--device cpu" in capsys.readouterr().err


def test_device_flag_parses():
    parser = cli.build_parser()
    assert parser.parse_args(["-i", "f"]).device == 0
    assert parser.parse_args(["-i", "f", "--device", "CPU"]).device == "cpu"
    assert parser.parse_args(["-i", "f", "--device", "1"]).device == 1
    with pytest.raises(SystemExit):
        parser.parse_args(["-i", "f", "--device", "gpu"])


def test_module_entry_point(libraries):
    """python -m hprlp_tpu_torch.cli, as a user runs it."""
    proc = subprocess.run(
        [sys.executable, "-m", "hprlp_tpu_torch.cli", "-i", MODEL,
         "--device", "cpu", "--quiet"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    fields = summary(proc.stdout.strip())
    assert fields["status"] == "OPTIMAL"
    assert float(fields["obj"]) == pytest.approx(-26.4, abs=1e-3)
