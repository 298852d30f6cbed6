"""The span recorder (hprlp_tpu_torch/spans.py) and the span trees of the
two solve paths on the CPU: nesting and ids, a span closed by an
exception, nothing collected and the profiler never entered without a
collector, one collector per thread; every time field of Results and
BatchedResults (and build_ingest's seconds) equal to its span's seconds,
bitwise; the spans in torch.profiler's chrome trace."""

import json
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hprlp_tpu_torch as ht
from hprlp_tpu_torch import spans
from hprlp_tpu_torch.problem import LpProblem
from hprlp_tpu_torch.solver import loop

OFF = ht.Parameters(verbose=False, use_presolve=False)


def _lp(seed=0, m=30, n=50):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.3, random_state=rng,
                  data_rvs=lambda k: rng.normal(size=k)).tocsr()
    x = rng.uniform(-1.0, 1.0, n)
    Ax = A @ x
    return A, Ax - 1.0, Ax + 1.0, x - 2.0, x + 2.0, rng.normal(size=n)


def _batch(B=3, seed=1):
    A, AL, AU, l, u, c = _lp(seed)
    rng = np.random.default_rng(seed)
    C = c[:, None] + 0.1 * rng.normal(size=(c.size, B))
    return (A, C, np.repeat(AL[:, None], B, 1), np.repeat(AU[:, None], B, 1),
            np.repeat(l[:, None], B, 1), np.repeat(u[:, None], B, 1))


def _by_name(records):
    out = {}
    for s in records:
        assert s.name not in out, s.name
        out[s.name] = s
    return out


def _unspanned(records):
    root = records[-1]
    kids = [s for s in records if s.parent == root.id]
    return root.seconds - sum(s.seconds for s in kids)


def test_nesting_parents_and_call_ids():
    with spans.collect() as recs:
        with spans.span("a", k=1) as a:
            with spans.span("b") as b:
                with spans.span("c") as c:
                    pass
            with spans.span("d") as d:
                pass
        with spans.span("e") as e:
            pass
    assert [s.name for s in recs] == ["c", "b", "d", "a", "e"]
    assert a.parent is None and a.call == a.id
    assert b.parent == a.id and d.parent == a.id and c.parent == b.id
    assert {s.call for s in (a, b, c, d)} == {a.id}
    assert e.parent is None and e.call == e.id != a.id
    assert a.attrs == {"k": 1}
    assert a.start <= b.start <= c.start <= c.end <= b.end <= d.start
    assert d.end <= a.end <= e.start
    assert all(s.seconds >= 0 for s in recs)
    assert [s.name for s in spans.last()] == ["e"]


def test_root_opens_only_where_no_span_is_open():
    with spans.collect() as recs:
        with spans.root("outer"):
            with spans.root("inner") as inner:
                with spans.span("x"):
                    pass
    assert inner is None
    assert [s.name for s in recs] == ["x", "outer"]
    assert recs[0].parent == recs[1].id


def test_span_closed_by_an_exception():
    with spans.collect() as recs:
        with pytest.raises(ValueError):
            with spans.span("outer"):
                with spans.span("inner"):
                    raise ValueError("x")
        with spans.span("after"):
            pass
    inner, outer, after = recs
    assert inner.attrs == {"error": "ValueError"}
    assert outer.attrs == {"error": "ValueError"}
    assert inner.end is not None and inner.parent == outer.id
    assert after.parent is None  # the stack was emptied


def test_off_collects_nothing_and_never_enters_the_profiler(monkeypatch):
    entered = []

    class Mark:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Mark)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    with spans.span("off"):
        pass
    assert entered == []
    with spans.collect() as recs:
        with spans.span("on"):
            pass
    assert entered == ["hprlp::on"] and [s.name for s in recs] == ["on"]
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: False)
    with spans.collect():
        with spans.span("no profiler"):
            pass
    assert entered == ["hprlp::on"]


def test_collectors_of_two_threads_stay_apart():
    seen, gate = {}, threading.Barrier(2, timeout=30)

    def work(tag):
        with spans.collect() as recs:
            gate.wait()
            for i in range(200):
                with spans.span(f"{tag}.outer"):
                    with spans.span(f"{tag}.inner"):
                        pass
            gate.wait()
        seen[tag] = recs

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for tag in "ab":
        assert len(seen[tag]) == 400
        assert {s.name.split(".")[0] for s in seen[tag]} == {tag}
        outers = {s.id for s in seen[tag] if s.name.endswith("outer")}
        assert all(s.parent in outers for s in seen[tag]
                   if s.name.endswith("inner"))


def test_solve_span_tree_and_time_fields():
    with spans.collect() as recs:
        res = ht.solve(*_lp(), OFF, device="cpu")
    assert res.status == "OPTIMAL"
    assert [s.name for s in recs] == [
        "checks", "ingest.host", "ingest.upload", "ingest.scaling",
        "ingest.layout", "ingest", "autotune", "power", "loop", "finish",
        "solve"]
    by = _by_name(recs)
    root = by["solve"]
    assert root.parent is None and {s.call for s in recs} == {root.id}
    for name in ("checks", "ingest", "autotune", "power", "loop", "finish"):
        assert by[name].parent == root.id, name
    for name in ("host", "upload", "scaling", "layout"):
        assert by["ingest." + name].parent == by["ingest"].id
    assert res.setup_time == (by["ingest"].seconds
                              - by["ingest.scaling"].seconds)
    assert res.scaling_time == by["ingest.scaling"].seconds
    assert res.autotune_time == by["autotune"].seconds
    assert res.power_time == by["power"].seconds
    assert res.time == by["loop"].seconds
    assert by["autotune"].attrs["choice"] == res.spmv_backend
    assert 0.0 <= _unspanned(recs) <= root.seconds
    assert [s.name for s in spans.last()] == [s.name for s in recs]


def test_solve_problem_alone_has_its_root():
    with spans.collect() as recs:
        res = ht.solve_problem(LpProblem.from_arrays(*_lp(2)), OFF,
                               device="cpu")
    assert recs[-1].name == "solve" and recs[-1].parent is None
    assert res.time == _by_name(recs)["loop"].seconds
    assert "checks" not in _by_name(recs)


def test_presolve_span_feeds_presolve_time():
    params = ht.Parameters(verbose=False)
    with spans.collect() as recs:
        res = ht.Model.from_arrays(*_lp(3)).solve(params, device="cpu")
    pre = [s for s in recs if s.name == "presolve"]
    assert len(pre) == 1 and res.presolve_time == pre[0].seconds
    assert pre[0].call == recs[-1].id and recs[-1].name == "solve"


def test_build_ingest_seconds_are_its_spans():
    problem = LpProblem.from_arrays(*_lp(4))
    with spans.collect() as recs:
        _, _, _, seconds = loop.build_ingest(problem, OFF, "cpu")
    by = _by_name(recs)
    assert seconds == {"host": by["ingest.host"].seconds,
                       "upload": by["ingest.upload"].seconds,
                       "scaling": by["ingest.scaling"].seconds,
                       "layout": by["ingest.layout"].seconds,
                       "wall": by["ingest"].seconds}


def test_solve_batched_span_tree_and_time_fields():
    with spans.collect() as recs:
        res = ht.solve_batched(*_batch(), params=OFF, device="cpu")
    assert res.status == ["OPTIMAL"] * 3
    # No dense probe and no graph capture on the CPU.
    assert [s.name for s in recs] == [
        "checks", "ingest.matrix", "ingest.vectors", "ingest", "power",
        "loop", "finish", "solve_batched"]
    by = _by_name(recs)
    root = by["solve_batched"]
    for name in ("checks", "ingest", "power", "loop", "finish"):
        assert by[name].parent == root.id, name
    for name in ("matrix", "vectors"):
        assert by["ingest." + name].parent == by["ingest"].id
    assert res.setup_time == by["ingest"].seconds
    assert res.power_time == by["power"].seconds
    assert res.solve_time == by["loop"].seconds
    assert res.time == res.setup_time + res.solve_time
    assert 0.0 <= _unspanned(recs) <= root.seconds


def test_solve_batched_spans_carry_the_bytes_moved():
    """ingest.vectors counts what it uploads (the five (rows, B) float64
    arrays and the two position maps), finish what it downloads (x, y, z
    in float64)."""
    args = _batch()
    with spans.collect() as recs:
        ht.solve_batched(*args, params=OFF, device="cpu")
    by = _by_name(recs)
    (m, n), B = args[0].shape, 3
    assert by["ingest.vectors"].attrs == {
        "h2d_bytes": 8 * B * (3 * n + 2 * m) + 8 * (m + n)}
    assert by["finish"].attrs == {"d2h_bytes": 8 * B * (2 * n + m)}


def test_spans_land_in_the_profilers_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with spans.collect(), profile(activities=[ProfilerActivity.CPU]) as p:
        ht.solve(*_lp(5), OFF, device="cpu")
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"hprlp::solve", "hprlp::ingest", "hprlp::loop"} <= names


NEW_SPANS = {"read", "presolve", "postsolve", "validate"}


def _mps(tmp_path, seed=6):
    from hprlp_tpu_torch.prof.problems import write_mps

    path = str(tmp_path / f"lp{seed}.mps")
    write_mps(LpProblem.from_arrays(*_lp(seed)), path)
    return path


@pytest.mark.parametrize("native", [True, False])
def test_solve_mps_spans_read_presolve_postsolve_validate(tmp_path, native,
                                                          monkeypatch):
    from hprlp_tpu_torch.io import native_mps

    monkeypatch.setattr(native_mps, "is_available", lambda: native)
    path = _mps(tmp_path)
    with spans.collect() as recs:
        res = ht.solve_mps(path, ht.Parameters(verbose=False), device="cpu")
    assert res.status == "OPTIMAL"
    by = _by_name(recs)
    root = by["solve"]
    assert recs[-1] is root and root.parent is None
    for name in NEW_SPANS | {"ingest", "loop"}:
        assert by[name].parent == root.id, name
    names = [s.name for s in recs if s.parent == root.id]
    assert names.index("read") < names.index("presolve") < \
        names.index("ingest") < names.index("loop") < \
        names.index("postsolve") < names.index("validate")
    m, n = _lp(6)[0].shape
    assert by["read"].attrs == {
        "reader": "native" if native else "python", "m": m, "n": n,
        "nnz": _lp(6)[0].nnz, "bytes": (tmp_path / "lp6.mps").stat().st_size}
    assert set(by["presolve"].attrs) == {"rows_removed", "cols_removed",
                                         "nnz_removed", "rounds"}
    assert all(isinstance(v, int) and v >= 0
               for v in by["presolve"].attrs.values())
    # The Results time fields are read off the spans they were before.
    assert res.presolve_time == by["presolve"].seconds
    assert res.setup_time == (by["ingest"].seconds
                              - by["ingest.scaling"].seconds)
    assert res.scaling_time == by["ingest.scaling"].seconds
    assert res.autotune_time == by["autotune"].seconds
    assert res.power_time == by["power"].seconds
    assert res.time == by["loop"].seconds
    assert 0.0 <= _unspanned(recs) <= root.seconds


def test_presolve_off_has_none_of_the_front_door_spans(tmp_path):
    with spans.collect() as recs:
        ht.solve(*_lp(7), OFF, device="cpu")
    assert not NEW_SPANS & {s.name for s in recs}
    with spans.collect() as recs:
        ht.solve_mps(_mps(tmp_path, 7), OFF, device="cpu")
    assert NEW_SPANS & {s.name for s in recs} == {"read"}


def test_model_from_arrays_with_presolve_has_no_read_span():
    with spans.collect() as recs:
        res = ht.Model.from_arrays(*_lp(8)).solve(
            ht.Parameters(verbose=False), device="cpu")
    assert res.status == "OPTIMAL"
    names = [s.name for s in recs]
    assert "read" not in names
    assert {"presolve", "postsolve", "validate"} <= set(names)
