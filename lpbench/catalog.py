"""Where the benchmark finds its parts: by the names in BENCHMARK.json.

A cell of `workloads` names a configuration and a traffic mix.  The
configuration is `configs/<name>.json`, whose "generator" names
`generators/<generator>.py`; the traffic mix is `traffic/<traffic>.json`,
whose "entry" names `entries/<entry>.py`; the limits of the numbers that
decide `correct` are `limits/<cell>.json`; a metric is the reader
`metrics/<name>.py` (`<base>.<part>`, a metric split by cell, the reader
`metrics/<base>.py`).  A later cell, configuration, traffic mix or metric
is added as files and entries, and no file here changes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json: each number compared, its limit
    generator: types.ModuleType
    entry: types.ModuleType
    chips: int
    end_to_end: list  # BENCHMARK.json's metrics that this cell reports
    per_layer: list


def load_module(path: str) -> types.ModuleType:
    """The Python file at `path`, imported once a process under a name
    made from its path."""
    path = os.path.abspath(path)
    name = "_lpbench_" + hashlib.sha1(path.encode()).hexdigest()[:16]
    if name in sys.modules:
        return sys.modules[name]
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    """Whether `cell` reports `metric`: the cells its "workloads" lists;
    without that key, every cell (end-to-end metrics, reported None) or
    every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def find_cell(name: str, root: str = ROOT, bench_dir: str = HERE) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files from
    bench_dir.  Raises KeyError for a cell the file does not name."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    gen_name = config.get("generator", w["config"])
    generator = load_module(
        os.path.join(bench_dir, "generators", f"{gen_name}.py"))
    entry = load_module(
        os.path.join(bench_dir, "entries", f"{traffic['entry']}.py"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    limits = _json(os.path.join(bench_dir, "limits", f"{name}.json"))
    return Cell(name=name, config=config, traffic=traffic, limits=limits,
                generator=generator, entry=entry, chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, bench_dir: str = HERE):
    """The `read(run)` function of metrics/<metric>.py.  A metric split by
    cell, `<base>.<part>` (a quantity whose cells move different end-to-end
    metrics), is read by metrics/<base>.py unless it has a file of its
    own."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(bench_dir, "metrics",
                            f"{metric.split('.')[0]}.py")
    return load_module(path).read
