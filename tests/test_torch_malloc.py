"""The port's host allocator tuning (hprlp_tpu_torch/_malloc.py, a pinned
copy of hprlp_tpu/_malloc.py: tests/test_torch_copies.py) against the JAX
package's: HPRLP_MALLOC_TUNE at import, tune_malloc's report, the
transparent-hugepage policy written and restored, preheat through the
port's host library, and the CLI's --malloc-tune solving data/model.mps.

Tuning changes the whole process, so every case runs in a subprocess.  No
case writes /sys: each points _malloc._THP_PATH at a file in tmp_path
before anything can tune, by loading the module under its package name
first (the package's __init__ then imports that module).
"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_presolve import libraries  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "data", "model.mps")
PACKAGES = {"port": "hprlp_tpu_torch", "jax": "hprlp_tpu"}

# argv: THP_FILE PACKAGE, then the case's own.  Loads PACKAGE._malloc with
# _THP_PATH at THP_FILE, so that nothing below writes /sys.
PRELOAD = """
import importlib.util, json, os, sys
thp_file, package = sys.argv[1], sys.argv[2]
name = package + "._malloc"
spec = importlib.util.spec_from_file_location(
    name, os.path.join(os.environ["ROOT"], package, "_malloc.py"))
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
m._THP_PATH = thp_file
sys.modules[name] = m
"""

IMPORT = PRELOAD + """
import importlib
importlib.import_module(package)
print(json.dumps({"done": m._done, "tuned": m.is_tuned(),
                  "thp": open(thp_file).read()}))
"""

TUNE = PRELOAD + """
report = m.tune_malloc(thp=True)
print(json.dumps({"report": report, "again": m.tune_malloc(thp=True),
                  "tuned": m.is_tuned(), "thp": open(thp_file).read()}))
"""

PREHEAT = PRELOAD + """
import hprlp_tpu_torch
first = m.preheat(1 << 20)
print(json.dumps({"tuned": m.is_tuned(), "first": first,
                  "again": m.preheat(1 << 20)}))
"""

CLI = PRELOAD + """
from hprlp_tpu_torch import cli
rc = cli.main(["-i", sys.argv[3], "--device", "cpu", "--malloc-tune",
               "--quiet"])
print(json.dumps({"rc": rc, "done": m._done,
                  "env": os.environ.get("HPRLP_MALLOC_TUNE"),
                  "thp": open(thp_file).read()}))
"""


def _run(code, package, tmp_path, env_tune=None, args=()):
    """(the case's JSON line, its stderr, the THP file after exit, its
    stdout)."""
    thp = tmp_path / f"thp_{package}"
    thp.write_text("always [madvise] never\n")
    env = dict(os.environ, ROOT=ROOT, PYTHONPATH=ROOT,
               JAX_PLATFORMS="cpu")
    env.pop("HPRLP_MALLOC_TUNE", None)
    if env_tune is not None:
        env["HPRLP_MALLOC_TUNE"] = env_tune
    proc = subprocess.run([sys.executable, "-c", code, str(thp),
                           PACKAGES[package], *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = proc.stdout.strip().splitlines()[-1]
    return json.loads(line), proc.stderr, thp.read_text(), proc.stdout


@pytest.mark.parametrize("env_tune,tuned", [(None, False), ("0", False),
                                            ("1", True)],
                         ids=["unset", "0", "1"])
def test_import_tunes_only_when_asked(env_tune, tuned, tmp_path):
    """Importing the port tunes the allocator only with HPRLP_MALLOC_TUNE=1
    (mallopt, and THP "always", restored to "madvise" at exit), as
    importing the JAX package does: the same state on both."""
    got = {}
    for package in ("port", "jax"):
        out, err, after, _ = _run(IMPORT, package, tmp_path, env_tune)
        assert out["tuned"] is tuned, package
        assert out["thp"] == ("always" if tuned
                              else "always [madvise] never\n"), package
        assert after == ("madvise" if tuned
                         else "always [madvise] never\n"), package
        assert ("transparent_hugepage: madvise -> always" in err) is tuned
        got[package] = out
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("env_tune", [None, "0"], ids=["unset", "0"])
def test_tune_malloc_reports_as_jax(env_tune, tmp_path):
    """tune_malloc(thp=True): with HPRLP_MALLOC_TUNE=0 it does nothing and
    reports "disabled"; else mallopt and THP "always" (restored at exit);
    a second call returns the first's report; the port's report and the
    THP file's states are the JAX package's."""
    got = {}
    for package in ("port", "jax"):
        out, _, after, _ = _run(TUNE, package, tmp_path, env_tune)
        got[package] = (out, after)
    assert got["port"] == got["jax"]
    out, after = got["port"]
    if env_tune == "0":
        assert out["report"] == {"mallopt": False, "thp": "disabled"}
        assert after == "always [madvise] never\n"
    else:
        assert out["report"] == {"mallopt": True, "thp": "always"}
        assert out["thp"] == "always" and after == "madvise"
    assert out["again"] == out["report"]


@pytest.mark.parametrize("env_tune", [None, "1"], ids=["untuned", "tuned"])
def test_preheat_touches_through_the_host_library(env_tune, tmp_path,
                                                  libraries):
    """preheat(n) pre-faults n bytes through the port's host library
    (hprlp_parallel_touch) once tuned, and then not again; untuned it is
    a no-op."""
    out, _, _, _ = _run(PREHEAT, "port", tmp_path, env_tune)
    if env_tune:
        assert out == {"tuned": True, "first": 1 << 20, "again": 0}
    else:
        assert out == {"tuned": False, "first": 0, "again": 0}


def test_cli_malloc_tune_solves_the_model(tmp_path, libraries):
    """cli.main --malloc-tune on data/model.mps: tuned as the JAX CLI
    tunes (tune_malloc(thp=True)), OPTIMAL at -26.4, exit 0; the
    environment passes HPRLP_MALLOC_TUNE=1 to any ranks it launches; the
    THP policy restored at exit."""
    out, err, after, stdout = _run(CLI, "port", tmp_path, args=(MODEL,))
    assert out["rc"] == 0
    line = [ln for ln in stdout.splitlines() if ln.startswith("status=")]
    assert len(line) == 1 and "status=OPTIMAL" in line[0]
    obj = float(line[0].split("obj=")[1].split()[0])
    assert obj == pytest.approx(-26.4, rel=1e-3)
    assert out["done"] == {"mallopt": True, "thp": "always"}
    assert out["env"] == "1" and out["thp"] == "always"
    assert after == "madvise"
    assert "transparent_hugepage: madvise -> always" in err


def test_peak_rss_sees_a_block_s_allocation():
    """prof/timing.py::PeakRss, which measures host memory where the
    kernel keeps no VmHWM: a 256 MiB array touched inside the block
    raises the sampled peak by at least 200 MiB over the start, and the
    start is this process's resident set."""
    import numpy as np

    from hprlp_tpu_torch.prof.timing import PeakRss

    with PeakRss(every=0.005) as rss:
        a = np.ones(256 << 20 >> 3)
        del a
    assert rss.start_bytes > 0
    assert rss.peak_bytes - rss.start_bytes >= 200 << 20
