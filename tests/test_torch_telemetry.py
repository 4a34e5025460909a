"""The port's telemetry (`repro_torch.telemetry`) against the reference's
contract (mirrors `tests/test_telemetry.py`): spans nest per thread and
export a valid Chrome trace, the subsystem is one shared no-op object when
disabled, `annotate` names its region on a `torch.profiler` timeline, and
metric snapshots merge as the reference's do (checked against
`repro.telemetry.metrics` on the same operations).
"""
import json
import threading
import time

import pytest
import torch

from repro.telemetry import metrics as jtm
from repro_torch import telemetry as tele
from repro_torch.telemetry import metrics as tm
from repro_torch.telemetry import spans as tsp


@pytest.fixture
def coll():
    c = tsp.enable(torch_profiler=False)
    yield c
    tsp.disable()


def test_disabled_spans_are_shared_noop():
    tsp.disable()
    assert not tsp.active()
    s = tsp.span("x", depth=3)
    assert s is tsp.span("y") is tsp.annotate("z")  # one shared object
    with s as live:
        assert live.sync("payload") == "payload"
    tsp.add_span("manual", 0.0, 1.0)  # silently dropped
    assert tele.collector() is None


def test_span_nesting_order_and_depth(coll):
    with tsp.span("a", k=1):
        with tsp.span("a.b"):
            pass
        with tsp.span("a.c", depth=7):  # attr named `depth` must survive
            pass
    recs = coll.records()
    assert [(r.name, r.depth) for r in recs] == \
        [("a.b", 1), ("a.c", 1), ("a", 0)]
    assert recs[2].attrs == {"k": 1}
    assert recs[1].attrs == {"depth": 7}
    a = recs[2]
    for child in recs[:2]:
        assert a.start <= child.start
        assert child.start + child.dur <= a.start + a.dur + 1e-6


def test_span_cancel_and_manual_add(coll):
    with tsp.span("dropped") as sp:
        sp.cancel()
    t0 = time.perf_counter()
    tsp.add_span("manual", t0, 0.25, bucket=(1, 2))
    recs = coll.records()
    assert [r.name for r in recs] == ["manual"]
    assert recs[0].dur == 0.25
    assert recs[0].attrs == {"bucket": [1, 2]}


def test_span_nesting_is_per_thread(coll):
    def worker():
        with tsp.span("thread.inner"):
            pass

    with tsp.span("main.outer"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    by_name = {r.name: r for r in coll.records()}
    assert by_name["thread.inner"].depth == 0
    assert by_name["main.outer"].depth == 0
    assert by_name["thread.inner"].tid != by_name["main.outer"].tid


def test_device_sync_takes_tensors_and_nests(coll):
    x = torch.arange(8.0)
    with tsp.span("sync", device_sync={"x": x}) as sp:
        assert sp.sync((x, [x])) == (x, [x])
        sp.sync(lambda: x)
    assert coll.names() == ["sync"]
    assert tele.device_sync((x, {"y": x})) == (x, {"y": x})


def test_annotate_records_span_and_profiler_region(coll):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tsp.annotate("region.eager", T=2):
            torch.ones(4).sum()
    assert coll.names() == ["region.eager"]
    assert coll.records()[0].attrs == {"trace_region": True, "T": 2}
    assert "region.eager" in {e.key for e in prof.key_averages()}


def test_torch_profiler_switch_names_every_span():
    c = tsp.enable(torch_profiler=True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tsp.span("plain.span"):
                torch.ones(4).sum()
        assert "plain.span" in {e.key for e in prof.key_averages()}
        assert c.names() == ["plain.span"]
    finally:
        tsp.disable()


def test_chrome_trace_schema(coll):
    with tsp.span("outer", physics="acoustic"):
        with tsp.span("inner"):
            pass
    trace = coll.chrome_trace()
    assert trace["displayTimeUnit"] == "ms"
    events = trace["traceEvents"]
    assert [e["name"] for e in events] == ["outer", "inner"]
    for e in events:
        assert e["ph"] == "X"
        assert set(e) >= {"name", "ph", "cat", "ts", "dur", "pid", "tid",
                          "args"}
        assert e["ts"] >= 0.0 and e["dur"] >= 0.0
        assert e["cat"] == e["name"].split(".")[0]
    o, i = events
    assert o["ts"] <= i["ts"] <= i["ts"] + i["dur"] <= \
        o["ts"] + o["dur"] + 1.0
    json.dumps(trace)


def test_export_roundtrip(tmp_path, coll):
    with tsp.span("e"):
        pass
    p = coll.export(str(tmp_path / "trace.json"))
    loaded = json.load(open(p))
    assert [e["name"] for e in loaded["traceEvents"]] == ["e"]
    q = coll.export_flat(str(tmp_path / "flat.json"))
    flat = json.load(open(q))
    assert flat[0]["name"] == "e" and "dur_s" in flat[0]


def _fill(mod):
    a, b = mod.MetricsRegistry(), mod.MetricsRegistry()
    a.counter("n").inc(2)
    b.counter("n").inc(3)
    b.counter("only_b").inc()
    a.gauge("g").set(1.0)
    b.gauge("g").set(9.0)
    for v in (1.0, 3.0):
        a.histogram("h").observe(v)
    b.histogram("h").observe(5.0)
    b.histogram("empty")
    return a, b


def test_metrics_snapshot_and_merge_match_reference():
    (a, b), (ja, jb) = _fill(tm), _fill(jtm)
    assert a.snapshot() == ja.snapshot()
    assert b.snapshot() == jb.snapshot()
    m = tm.merge_snapshots(a.snapshot(), b.snapshot())
    assert m == jtm.merge_snapshots(ja.snapshot(), jb.snapshot())
    assert m["counters"] == {"n": 5, "only_b": 1}
    assert m["gauges"]["g"] == 9.0
    assert m["histograms"]["h"] == {
        "count": 3, "total": 9.0, "min": 1.0, "max": 5.0, "mean": 3.0}
    with pytest.raises(TypeError):
        a.gauge("n")
    a.clear()
    assert a.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert tele.registry() is tm.registry()
