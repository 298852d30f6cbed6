"""The harness on the CPU: tiny rehearsals of both entries print a last
line of the contract's shape; the command refuses to run without a card;
faults planted under the timed path turn `correct` false; no module of JAX
or of the JAX package is loaded.  One test needs the card and skips here."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hprlp_tpu_torch as ht
from lpbench import catalog, run as harness
from conftest import A, ROOT, S, tiny_cell

CPU = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def _rehearse(cell, trace=False, seed=2**31 + 11, seconds=0.5):
    """execute + finish on the CPU: (exit code, the last stdout line's
    object, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    sys_out, sys_err = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err
    try:
        run = harness.execute(cell, seed, seconds, trace, device="cpu",
                              t_start=0.0)
        rc = harness.finish(run, dict(CPU))
    finally:
        sys.stdout, sys.stderr = sys_out, sys_err
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), err.getvalue()


@pytest.mark.parametrize("name", [S, A])
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_prints_the_contract_line(name, trace):
    cell = tiny_cell(name)
    rc, line, err = _rehearse(cell, trace)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] >= cell.traffic["batch"]
    assert line["failed"] == 0
    wanted = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in wanted}
    assert set(line["metrics"]) <= set(units)
    for key, m in line["metrics"].items():
        assert m["unit"] == units[key] and m["value"] > 0
    if trace:
        # No device on the CPU: no device readings, and the idle time
        # named by the host's samples.
        # Setcover's per-layer metrics are split by cell (".solve").
        part = ".solve" if name == S else ""
        assert "halves_roofline" + part not in line["metrics"]
        assert {"solve_p95_s" + part, "ingest_s" + part, "loop_s" + part,
                "iters" + part} <= set(line["metrics"])
        assert line["device"]["window_s"] > 0
        assert line["breakdown"]["idle_gaps"]
    else:
        # No device on the CPU, so no peak memory: setcover, whose only
        # other end-to-end metric that is, reports set-up alone here.
        assert "setup_s" in line["metrics"]
        assert ("lps_per_s" in line["metrics"]) == (name == A)
    # The numbers compared end stderr, each beside its limit.
    tail = err.strip().splitlines()[-2:]
    assert tail[0].startswith("kkt_worst ") and " limit " in tail[0]
    assert tail[1] == "not_optimal 0 limit 0"
    assert line["checks"]["kkt_worst"]["limit"] == \
        cell.limits["kkt_worst"]


def test_same_seed_same_pool_other_seed_other_pool():
    cell = tiny_cell(S)
    pools = [cell.entry.make_pool(cell.generator, cell.config, cell.traffic,
                                  harness.seeded(s, "cpu"))
             for s in (5, 5, 6)]
    assert np.array_equal(pools[0][1]["c"], pools[1][1]["c"])
    assert not np.array_equal(pools[0][1]["c"], pools[2][1]["c"])


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the command would run")
    proc = subprocess.run(
        [sys.executable, "-m", "lpbench.run", "--workload", S, "--seed",
         "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_command_fails_without_the_program(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(catalog.HERE, tmp_path / "lpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "lpbench.run", "--workload", S, "--seed",
         "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_no_jax_module_is_loaded():
    """The harness, the reference and a rehearsal in a fresh interpreter
    load nothing whose top-level name is jax, jaxlib, flax or hprlp_tpu;
    the reference loads nothing of the program either."""
    code = (
        "import sys\n"
        "import lpbench.reference, lpbench.roofline\n"
        "bad = {'jax', 'jaxlib', 'flax', 'hprlp_tpu', 'hprlp_tpu_torch'}\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & bad))\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'lpbench', 'tests')!r})\n"
        "from conftest import tiny_cell, S\n"
        "from lpbench import run\n"
        "r = run.execute(tiny_cell(S), 1, 0.2, True, device='cpu')\n"
        "print(run.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "[]" and lines[-1] == "[]"


# Faults planted under the timed path; each turns `correct` false.

def _stuck(monkeypatch):
    """A step that returns its state unchanged."""
    from hprlp_tpu_torch.solver import batched_device_loop, device_loop

    monkeypatch.setattr(device_loop, "run_chunk",
                        lambda lp, sc, state, *a, **k: (state,) + tuple(
                            _real_chunk(lp, sc, state, *a, **k)[1:]))
    monkeypatch.setattr(batched_device_loop, "run_batched_chunk",
                        lambda lp, rn, cn, state, *a, **k: (state,) + tuple(
                            _real_bchunk(lp, rn, cn, state, *a, **k)[1:]))


def _half_batch(monkeypatch):
    """Half of the batch left out: the first half solved, its answers
    standing for the rest."""
    real = ht.solve_batched

    def half(A, C, AL, AU, l, u, params=None, device=None):
        h = C.shape[1] // 2
        r = real(A, C[:, :h], AL[:, :h], AU[:, :h], l[:, :h], u[:, :h],
                 params=params, device=device)
        for key in ("x", "y", "z"):
            setattr(r, key, np.asfortranarray(np.tile(getattr(r, key),
                                                      (1, 2))))
        for key in ("primal_obj", "residuals", "gap", "iter"):
            setattr(r, key, np.tile(getattr(r, key), 2))
        r.status = r.status * 2
        r.batch_size = 2 * h
        return r

    monkeypatch.setattr(ht, "solve_batched", half)


def _altered(monkeypatch):
    """An answer altered where it is produced: x[0] of every LP + 1."""
    real_one, real_many = ht.solve, ht.solve_batched

    def one(*a, **k):
        r = real_one(*a, **k)
        r.x = r.x.copy()
        r.x[0] += 1.0
        return r

    def many(*a, **k):
        r = real_many(*a, **k)
        r.x = np.array(r.x, order="F")
        r.x[0, :] += 1.0
        return r

    monkeypatch.setattr(ht, "solve", one)
    monkeypatch.setattr(ht, "solve_batched", many)


from hprlp_tpu_torch.solver.batched_device_loop import \
    run_batched_chunk as _real_bchunk  # noqa: E402
from hprlp_tpu_torch.solver.device_loop import \
    run_chunk as _real_chunk  # noqa: E402


@pytest.mark.parametrize("name,fault", [
    (S, _stuck), (S, _altered), (A, _stuck), (A, _half_batch),
    (A, _altered)])
def test_fault_turns_correct_false(name, fault, monkeypatch):
    fault(monkeypatch)
    # A stuck solve never converges: the iteration limit ends it.
    rc, line, err = _rehearse(tiny_cell(name, max_iter=600), seconds=0.2)
    assert rc == 0
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["kkt_worst"]["value"] > checks["kkt_worst"]["limit"] or \
        checks["not_optimal"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", [S, A])
def test_command_on_the_card(name):
    """The command itself, a short window, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "lpbench.run", "--workload", name, "--seed",
         str(2**31 + 5), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["peak_mem_gib" if name == S else
                           "lps_per_s"]["value"] > 0
