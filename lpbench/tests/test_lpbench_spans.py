"""The span readers and lpbench/span_trace.py on the CPU: a traced
rehearsal of each tiny cell reads the program's spans of its profiled
call, an untraced one reports what it did before, a program without the
recorder gives nothing, and the device's idle time of a made-up trace is
charged to the innermost program span that holds it."""

import io
import json
import sys
import types

import pytest

from lpbench import catalog, run as harness, span_trace, span_tree
from conftest import A, S, tiny_cell

CPU = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
# The new readers by cell; the probe runs on the card only.
NEW = {S: ["checks_s.solve", "ingest_host_s.solve", "ingest_layout_s.solve",
           "finish_s.solve", "unspanned_s.solve"],
       A: ["checks_s", "ingest_vectors_s", "finish_s", "unspanned_s"]}


def _rehearse(cell, trace):
    out, sys_out = io.StringIO(), sys.stdout
    sys.stdout = out
    try:
        run = harness.execute(cell, 2**31 + 7, 0.3, trace, device="cpu",
                              t_start=0.0)
        rc = harness.finish(run, dict(CPU))
    finally:
        sys.stdout = sys_out
    return rc, run, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", [S, A])
def test_traced_rehearsal_reads_the_profiled_calls_spans(name):
    rc, run, line = _rehearse(tiny_cell(name), True)
    assert rc == 0 and line["correct"] is True
    for metric in NEW[name]:
        assert line["metrics"][metric]["unit"] == "s"
        assert line["metrics"][metric]["value"] > 0, metric
    assert "probe_s" not in line["metrics"]
    tree = span_tree.tree(run)
    root = "solve" if name == S else "solve_batched"
    assert tree["spans"][root] >= tree["spans"]["loop"] > 0
    assert 0 < tree["unspanned_s"] < tree["spans"][root]
    # The root is the profiled call's: within the wall around it.
    assert tree["spans"][root] <= run.trace["window_s"]


@pytest.mark.parametrize("name", [S, A])
def test_untraced_rehearsal_reports_no_span_metric(name):
    cell = tiny_cell(name)
    rc, run, line = _rehearse(cell, False)
    assert rc == 0
    assert set(line["metrics"]) <= {m["name"] for m in cell.end_to_end}
    assert span_tree.tree(run) is None


def test_readers_give_nothing_without_the_recorder(monkeypatch):
    run = types.SimpleNamespace(trace_on=True, profiled={"iters": 1})
    import hprlp_tpu_torch

    monkeypatch.delattr(hprlp_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "hprlp_tpu_torch.spans", None)
    for name in NEW[S] + NEW[A] + ["probe_s"]:
        assert catalog.reader(name)(run) is None


def test_every_new_metric_has_a_reader_and_its_cell():
    cells = {S: catalog.find_cell(S), A: catalog.find_cell(A)}
    for name, metrics in NEW.items():
        per_layer = {m["name"]: m for m in cells[name].per_layer}
        for metric in metrics + (["probe_s"] if name == A else []):
            m = per_layer[metric]
            assert m["source"] == "program_span" and m["workloads"] == [name]
            assert callable(catalog.reader(metric))


def _rec(name, s, e, ident, parent):
    r = types.SimpleNamespace(name=name, start=s, end=e, id=ident,
                              parent=parent)
    r.seconds = e - s
    return r


def test_summary_sums_names_and_leaves_the_uncovered_root():
    recs = [_rec("a", 1.0, 2.0, 2, 1), _rec("a.x", 1.2, 1.5, 3, 2),
            _rec("b", 3.0, 4.0, 4, 1), _rec("b", 4.5, 5.0, 5, 1),
            _rec("solve", 0.0, 6.0, 1, None)]
    got = span_tree.summary(recs)
    assert got["spans"] == {"a": 1.0, "a.x": pytest.approx(0.3),
                            "b": 1.5, "solve": 6.0}
    assert got["unspanned_s"] == pytest.approx(6.0 - 2.5)


def _annotation(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _busy(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
            "args": {}}


def test_idle_spans_charges_the_innermost_span():
    from lpbench import trace

    ev = [_annotation(trace.MARK, 0.0, 1000.0),
          _annotation("hprlp::solve", 10.0, 980.0),
          _annotation("hprlp::ingest", 20.0, 300.0),
          _annotation("hprlp::ingest.host", 20.0, 100.0),
          _annotation("hprlp::loop", 400.0, 500.0),
          # On the device's own timeline: not a program span.
          {"ph": "X", "cat": "gpu_user_annotation", "name": "hprlp::loop",
           "ts": 0.0, "dur": 1000.0},
          _busy(150.0, 100.0), _busy(450.0, 400.0)]
    got = span_trace.idle_spans(ev)
    us = {"no span": 10 + 10, "solve": 10 + 80 + 90,
          "ingest.host": 100, "ingest": 30 + 70,
          "loop": 50 + 50}
    assert got == pytest.approx({k: v / 1e6 for k, v in us.items()})
    assert sum(got.values()) == pytest.approx((1000 - 500) / 1e6)


def test_span_trace_calls_on_the_cpu():
    out = io.StringIO()
    rows = span_trace.calls(tiny_cell(S), 5, 1, device="cpu", out=out)
    assert [r["mode"] for r in rows] == ["off", "collect", "profile"]
    assert "spans" not in rows[0]
    for r in rows[1:]:
        assert r["spans"]["solve"] > r["unspanned_s"] > 0
    prof = rows[2]
    # No device on the CPU: the whole call is idle, in the spans.
    assert prof["busy_s"] == 0
    assert sum(prof["idle_spans"].values()) == \
        pytest.approx(prof["window_s"], rel=1e-6)
    assert prof["idle_in_children"] > 0.5
    assert len(out.getvalue().splitlines()) == 3
    cost = span_trace.span_cost(1000)
    assert cost["span_off_us"] > 0 and cost["span_collected_us"] > 0
