"""The port's observability export against the JAX reference's
(repro_torch.obs vs repro.obs): the same bundles give the same Chrome
trace document through ``merge_wire`` / ``to_chrome``, the same
``validate_chrome`` verdicts, and ``overlap_report`` the same numbers; the
JSONL sink writes the reference's lines for the same events, and gauges
and ``Histogram.merge_counts`` behave as the reference's.  Installing a
tracer does not change a single bit of a port run (the span sites only
read the clock), and the disabled tracer reads none.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.obs import report as jreport
from repro.obs import trace as jtrace
from repro_torch.obs import metrics, report, trace


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    """Every test starts and ends with tracing disabled in both packages."""
    trace.uninstall()
    jtrace.uninstall()
    yield
    trace.uninstall()
    jtrace.uninstall()


def _bundle(process: str, offset: float = 0.0, t_base: float = 100.0):
    """A port tracer's export with spans at fixed times: a worker-shaped
    timeline, chunk and wait spans on this thread, ship spans on a sender
    thread."""
    tr = trace.Tracer(process, capacity=64)
    tr.offset = offset
    for k, (c0, c1) in enumerate([(0.0, 0.10), (0.10, 0.18), (0.18, 0.26)]):
        r0 = 4 * k
        tr._record("exec/chunk", "exec", t_base + c0, t_base + c1,
                   {"start_round": r0, "rounds": 4})
        tr._record("uplink/wait", "uplink", t_base + c1 - 0.01,
                   t_base + c1, {"start_round": r0})

    def ships():
        for k, (s0, s1) in enumerate([(0.09, 0.16), (0.17, 0.25),
                                      (0.26, 0.3)]):
            tr._record("uplink/ship", "uplink", t_base + s0, t_base + s1,
                       {"start_round": 4 * k, "nbytes": 1000 + k})

    t = threading.Thread(target=ships, name="sender")
    t.start()
    t.join()
    return tr.export_wire()


def test_chrome_document_is_the_references():
    bundles = [_bundle("server", 0.0, 50.0), _bundle("worker0", 49.5)]
    # the same bundles through both packages' merge
    doc = trace.to_chrome(bundles)
    assert doc == jtrace.to_chrome(bundles)
    assert json.dumps(doc) == json.dumps(jtrace.to_chrome(bundles))
    assert trace.validate_chrome(doc) == [] == jtrace.validate_chrome(doc)
    assert trace.merge_wire(bundles + [None, bundles[0]]) == \
        jtrace.merge_wire(bundles + [None, bundles[0]])


def test_a_reference_bundle_merges_in_the_port_and_back():
    jt = jtrace.Tracer("jax-worker", capacity=8)
    with jt.span("outer", "cat", k=1):
        with jt.span("inner", "cat") as sp:
            sp.set(nbytes=7)
    tt = trace.Tracer("torch-server", capacity=8)
    with tt.span("commit", "server"):
        pass
    tt.pid = jt.pid + 1  # two processes' bundles
    bundles = [tt.export_wire(), jt.export_wire()]
    assert trace.to_chrome(bundles) == jtrace.to_chrome(bundles)


def test_validate_flags_the_same_problems():
    bad = {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 1, "tid": 0, "ts": 0, "dur": 10},
        {"ph": "X", "name": "b", "pid": 1, "tid": 0, "ts": 5, "dur": 10},
        {"ph": "Q", "name": "c", "pid": 1, "tid": 0},
        {"ph": "X", "name": "d", "pid": 1, "ts": -1},
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0},
        "junk"]}
    errs = trace.validate_chrome(bad)
    assert errs == jtrace.validate_chrome(bad) and len(errs) == 6
    assert trace.validate_chrome([]) == jtrace.validate_chrome([])


def test_overlap_report_gives_the_references_numbers():
    doc = trace.to_chrome([_bundle("worker0")])
    got, ref = report.overlap_report(doc), jreport.overlap_report(doc)
    assert got == ref
    assert got["steady"]["chunks"] == 2
    assert report.hidden_fraction(doc) == jreport.hidden_fraction(doc)
    with_ref = report.overlap_report(doc, compute_ref_s=0.05)
    assert with_ref == jreport.overlap_report(doc, compute_ref_s=0.05)
    assert report.format_report(got) == jreport.format_report(ref)


def test_the_roofline_diff_raises_and_names_its_item(tmp_path, capsys):
    """The roofline wire model is ported: ``overlap_report(model=)`` and
    ``--bw`` give the reference's report, its roofline block included."""
    from repro.roofline.analysis import WireModel as JWireModel
    from repro_torch.roofline.analysis import WireModel

    doc = trace.to_chrome([_bundle("worker0")])
    got = report.overlap_report(doc, model=WireModel(bw=2e4, latency_s=1e-3))
    ref = jreport.overlap_report(doc, model=JWireModel(bw=2e4,
                                                       latency_s=1e-3))
    assert got == ref and "roofline" in got
    assert all("wire_model_s" in r for r in got["chunks"])
    p = tmp_path / "t.json"
    trace.write_chrome(doc, str(p))
    assert report.main([str(p), "--bw", "1e9"]) == 0
    assert jreport.main([str(p), "--bw", "1e9"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]
    assert out[len(out) // 2 - 1].startswith("roofline: predicted hidden=")


def test_clis(tmp_path, capsys):
    doc = trace.to_chrome([_bundle("worker0")])
    p = tmp_path / "t.json"
    trace.write_chrome(doc, str(p))
    for mod in (trace, jtrace):
        assert mod.main(["summary", str(p)]) == 0
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half] == out[half:] and "uplink/ship" in "".join(out)
    assert report.main([str(p)]) == 0 and jreport.main([str(p)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]
    (tmp_path / "bad.json").write_text('{"traceEvents": [{"ph": "Q"}]}')
    assert trace.main(["validate", str(tmp_path / "bad.json")]) == 1


def test_summary_totals_the_device_track_apart(tmp_path, capsys,
                                               monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(trace, "now", lambda: clock.t)
    dev = _FakeEvents(clock)
    tr = trace.Tracer("p", events=dev)
    _device_spans(tr, clock, dev, 1.0)
    tr.settle()
    p = tmp_path / "t.json"
    trace.write_chrome(trace.to_chrome([tr.export_wire(device=True)]),
                       str(p))
    assert trace.main(["summary", str(p)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "valid: 4 spans across 1 process(es), 2.500s total " \
        "span time"
    assert out[1].split() == ["outer", "1", "spans", "1.0000s"]
    assert out[2].split() == ["inner", "1", "spans", "0.2500s"]
    assert out[3].split() == ["device", "track", "host", "s", "device", "s"]
    assert out[4].split() == ["outer", "1.0000", "1.0000"]
    assert out[5].split() == ["inner", "0.2500", "0.2500"]


def test_tracer_surface():
    assert isinstance(trace.get(), trace.NullTracer)
    assert trace.span("a") is trace.span("b")  # no allocation when off
    with trace.timed("x", "t") as tm:
        pass
    assert tm.seconds >= 0.0
    tr = trace.install("p")
    assert trace.install("q") is tr and trace.get() is tr
    with trace.timed("y", "t", k=2):
        pass
    trace.instant("mark")
    assert tr.n_spans == 2
    assert trace.uninstall() is tr and trace.uninstall() is None
    assert trace.clock_offset(1.0, 3.0, 10.0) == \
        jtrace.clock_offset(1.0, 3.0, 10.0) == 8.0
    ring = trace.Tracer("r", capacity=2)
    for i in range(5):
        with ring.span(f"s{i}"):
            pass
    wire = ring.export_wire()
    assert ring.dropped == 3 and [wire["names"][i] for i in
                                  wire["name_ix"]] == ["s3", "s4"]


def test_disabled_tracer_reads_no_clock(monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "now", lambda: calls.append(1) or 0.0)
    with trace.span("a", "b", k=1) as sp:
        sp.set(x=1)
    with trace.span("d", "b", device=True) as sp:
        assert sp is trace.span("e")  # the one shared no-op span
    trace.instant("c")
    trace.get().settle()
    assert trace.get().counters() is None
    assert trace.get().export_wire(device=True) is None
    assert calls == []


class _Clock:
    """The host clock of the device-track tests, moved by hand."""

    t = 0.0


class _FakeEvents:
    """A device whose clock is the host's plus 1000 s, running ``lag``
    seconds behind the host's enqueueing; counts the events it makes."""

    def __init__(self, clock):
        self.clock, self.lag, self.made, self.mode = clock, 0.0, 0, 0
        self.stats = {"num_device_alloc": 5, "num_device_free": 2,
                      "num_alloc_retries": 0}

    def ready(self):
        return True

    def new(self):
        self.made += 1
        return type("Event", (), {"t": None})()

    def record(self, ev):
        ev.t = self.clock.t + 1000.0 + self.lag

    def done(self, ev):
        return True

    def wait(self, ev):
        pass

    def ms(self, a, b):
        return (b.t - a.t) * 1e3

    def label(self):
        return "cuda:0"

    def alloc_stats(self):
        return dict(self.stats)

    def sync_mode(self, mode=None):
        old = self.mode
        if mode is not None:
            self.mode = mode
        return old


def _device_spans(tr, clock, dev, t):
    """An outer device span over [t, t + 1] with an inner one over
    [t + 0.5, t + 0.75], enqueued while the device runs 0.25 s behind."""
    dev.lag = 0.25
    clock.t = t
    with tr.span("outer", "x", device=True):
        clock.t = t + 0.5
        with tr.span("inner", "x", device=True):
            clock.t = t + 0.75
        clock.t = t + 1.0
    dev.lag = 0.0  # drained by the host sync
    clock.t = t + 2.0


def test_device_track_maps_onto_the_host_clock(monkeypatch):
    """``settle`` maps each span's event pair through the anchor onto the
    tracer clock, on a ``cuda:0`` track beside the host spans, nested as
    they were opened; the events are pooled across ``settle`` calls."""
    clock = _Clock()
    monkeypatch.setattr(trace, "now", lambda: clock.t)
    dev = _FakeEvents(clock)
    tr = trace.Tracer("p", events=dev)
    _device_spans(tr, clock, dev, 1.0)
    tr.settle()
    made = dev.made
    _device_spans(tr, clock, dev, 10.0)
    tr.settle()
    assert dev.made == made == 5  # 2 pairs and the anchor, then reused
    wire = tr.export_wire(device=True)
    assert wire["tids"] == ["MainThread", "cuda:0"]
    got = sorted((wire["tids"][t], wire["names"][n], a, b) for n, t, a, b in
                 zip(wire["name_ix"], wire["tid_ix"], wire["t0"],
                     wire["t1"]))
    want = []
    for t in (1.0, 10.0):
        want += [("MainThread", "inner", t + 0.5, t + 0.75),
                 ("MainThread", "outer", t, t + 1.0),
                 ("cuda:0", "inner", t + 0.75, t + 1.0),
                 ("cuda:0", "outer", t + 0.25, t + 1.25)]
    assert [g[:2] for g in got] == [w[:2] for w in sorted(want)]
    np.testing.assert_allclose([g[2:] for g in got],
                               [w[2:] for w in sorted(want)], atol=1e-9)
    doc = trace.to_chrome([wire])
    assert trace.validate_chrome(doc) == []
    args = [e["args"] for e in doc["traceEvents"]
            if e.get("ph") == "X" and e["tid"] == 1]
    assert args == [{"anchor_err_us": 0.0}] * 4
    # the bundle without the device track is the host spans' alone
    host = tr.export_wire()
    assert len(host["t0"]) == 4 and set(host["tid_ix"]) == {0}
    assert trace.to_chrome([host]) == jtrace.to_chrome([host])


def test_chunk_counters_count_syncs_and_show_none(recwarn):
    """``counters`` counts the sync-debug warnings (and shows none) and
    reads the allocator; ``uninstall`` restores the sync-debug mode."""
    import warnings

    tr = trace.install("p")
    dev = tr.events = _FakeEvents(_Clock())
    before = tr.counters()
    assert dev.mode == "warn"
    for _ in range(3):  # one line, counted every time
        warnings.warn(trace.SYNC_WARNING)
    warnings.warn("another warning")
    dev.stats["num_device_free"] += 4
    dev.stats["num_alloc_retries"] += 1
    assert trace.counter_deltas(before, tr.counters()) == {
        "syncs": 3, "mallocs": 4, "alloc_retries": 1}
    assert [str(w.message) for w in recwarn] == ["another warning"]
    assert trace.uninstall() is tr and dev.mode == 0
    assert trace.latest() is tr


def test_metrics_gauge_merge_and_snapshot_are_the_references():
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for r in (reg, jreg):
        r.counter("uplink/bytes").add(10)
        r.gauge("commit/weight").set(0.5)
        r.gauge("commit/weight").set(0.25)
        h = r.histogram("arrival/age", buckets=8)
        h.observe([0, 1, 1, 9])
        h.merge_counts(np.arange(8))
        r.histogram("lat", edges=[0.1, 1.0]).observe(0.5, n=3)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.gauge("commit/weight").value == 0.25
    with pytest.raises(ValueError, match="cannot merge"):
        reg.histogram("arrival/age").merge_counts(np.ones(3))
    with pytest.raises(TypeError):
        reg.gauge("uplink/bytes")
    assert reg.histogram("arrival/age").quantile(0.5) == \
        jreg.histogram("arrival/age").quantile(0.5)


def test_jsonl_lines_are_the_references(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "perf_counter", lambda: 12.5)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    reg = metrics.MetricsRegistry()
    reg.counter("commits").add(2)
    reg.gauge("commit/weight").set(1.0)
    for mod, name in ((metrics, "t.jsonl"), (jmetrics, "j.jsonl")):
        with mod.JsonlSink(str(tmp_path / name)) as sink:
            sink.write("commit", worker=0, version=1, nbytes=100, age=0,
                       weight=1.0)
            sink.write_snapshot(reg, rounds_done=8)
    t = (tmp_path / "t.jsonl").read_text()
    assert t == (tmp_path / "j.jsonl").read_text()
    assert len(t.splitlines()) == 2


def test_traced_run_is_bitwise_the_untraced_one():
    """Installing a tracer perturbs no number: a traced port run (engine,
    supplier and runtime spans) equals the untraced one bitwise."""
    from repro_torch.fed.runtime import RuntimeArgs, _fields_bitwise, run_local

    torch.set_num_threads(1)
    a = RuntimeArgs(clients=4, m=8, dim=12, tau=2, rounds=4, chunk=2,
                    batch_size=3, device="cpu")
    base = run_local(a)
    tr = trace.install("test")
    try:
        traced = run_local(a)
    finally:
        trace.uninstall()
    names = [tr._names[i] for i in tr.export_wire()["name_ix"]]
    assert {"exec/chunk", "exec/host_sync", "supplier/stage", "exec/supply",
            "exec/local", "exec/compress", "exec/server"} <= set(names)
    # tau local steps a round, each its gradient and its update
    assert names.count("local/grad") == names.count("local/update") \
        == a.tau * a.rounds
    assert _fields_bitwise(base["fields"], traced["fields"])
    assert base["metrics"]["train_loss"] == traced["metrics"]["train_loss"]


def test_engine_chunks_carry_their_counters_and_device_track(monkeypatch):
    """With a device side, every chunk span carries the chunk's counters
    and the stage spans land on the device track, inside their chunk."""
    import warnings

    from repro_torch.fed.runtime import RuntimeArgs, _engine, _supplier

    torch.set_num_threads(1)
    a = RuntimeArgs(clients=2, m=8, dim=6, tau=2, rounds=4, chunk=2,
                    batch_size=3, device="cpu")
    eng, _alg, _g, data, params0 = _engine(a, a.clients)
    sup = _supplier(a, data, 0, a.clients)
    sample = sup.sample_chunk

    def syncing(*args, **kw):  # one sync a chunk, as a copy to the host
        warnings.warn(trace.SYNC_WARNING)
        return sample(*args, **kw)

    monkeypatch.setattr(sup, "sample_chunk", syncing)
    tr = trace.install("p")
    tr.events = _FakeEvents(_Clock())
    try:
        eng.run(eng.init(params0), sup, a.rounds, seed=0)
    finally:
        trace.uninstall()
    doc = trace.to_chrome([tr.export_wire(device=True)])
    assert trace.validate_chrome(doc) == []
    chunks = [e["args"] for e in doc["traceEvents"]
              if e.get("name") == "exec/chunk"]
    assert chunks == [{"start_round": r, "rounds": 2, "syncs": 1,
                       "mallocs": 0, "alloc_retries": 0} for r in (0, 2)]
    device = [e["name"] for e in doc["traceEvents"]
              if e.get("ph") == "X" and e["tid"] == 1]
    assert device.count("local/grad") == a.tau * a.rounds
    assert {"exec/supply", "exec/local", "exec/compress", "exec/server",
            "local/update"} <= set(device)
    assert "exec/chunk" not in device and "exec/host_sync" not in device


def test_the_trace_timebase_is_the_references():
    assert trace.now is time.perf_counter
    assert trace.SCHEMA == jtrace.SCHEMA
    assert metrics.SCHEMA == jmetrics.SCHEMA
