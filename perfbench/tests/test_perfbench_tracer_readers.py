"""The readers of the program's own tracer on a hand-built window: the
device track's stage intervals and the chunk spans' counters, each reader
with its exact value, and ``None`` wherever the program's tracer holds
nothing for it (no device track, no counters, another window, a program
without ``latest``)."""
import _pbpath  # noqa: F401
import pytest

from pb import bench, measure, tracer
from repro_torch.obs import trace

ROUNDS = 8  # two chunks of 4
BASE = 100.0  # the program's clock at the window's start


def _program_tracer(device=True, counters=True):
    """Two chunks over [0.5, 1.5] and [1.5, 2.5] of the window; on the
    device track, per chunk, grads of 0.1 s, updates of 0.02 s, a server
    half of 0.01 s and a compressor of 0.005 s."""
    tr = trace.Tracer("perfbench")
    for k, (c0, c1) in enumerate([(0.5, 1.5), (1.5, 2.5)]):
        args = {"start_round": 4 * k, "rounds": 4}
        if counters:
            args.update(syncs=1 + k, mallocs=2 * k, alloc_retries=0)
        tr._record("exec/chunk", "exec", BASE + c0, BASE + c1, args)
        tr._record("exec/host_sync", "exec", BASE + c1 - 0.01, BASE + c1,
                   None)
        if not device:
            continue
        t = BASE + c0
        for name, dur in [("local/grad", 0.1), ("local/update", 0.02),
                          ("exec/server", 0.01), ("exec/compress", 0.005)]:
            tr._record(name, "x", t, t + dur, None, track="cuda:0")
            tr._record(name, "x", t, t + 0.001, None)  # its host span
            t += dur
    return tr


def _window(tr):
    """The ``Trace`` the harness builds from that tracer's host spans."""
    wire = tr.export_wire()
    spans = [(wire["names"][i], a - BASE, b - BASE) for i, a, b in
             zip(wire["name_ix"], wire["t0"], wire["t1"])]
    return measure.Trace(window_s=2.6, rounds=ROUNDS, kernels=[],
                         spans=spans, costs={})


WANT = {
    "engine.grad_device_ms_per_round": 2 * 100.0 / ROUNDS,
    "engine.update_device_ms_per_round": 2 * 20.0 / ROUNDS,
    "engine.server_device_ms_per_round": 2 * 15.0 / ROUNDS,
    "engine.host_syncs_per_round": 3 / ROUNDS,
    "device.malloc_calls_per_round": 2 / ROUNDS,
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_the_program_tracer(metric, monkeypatch):
    tr = _program_tracer()
    monkeypatch.setattr(trace, "latest", lambda: tr)
    assert bench.reader(metric)(_window(tr)) == pytest.approx(
        WANT[metric], rel=1e-9)


@pytest.mark.parametrize("metric", sorted(WANT))
@pytest.mark.parametrize("case", ["no_device_track", "no_counters",
                                  "another_window", "no_tracer",
                                  "no_latest"])
def test_reader_gives_none_without_its_records(metric, case, monkeypatch):
    tr = _program_tracer(device=case != "no_device_track",
                         counters=case != "no_counters")
    window = _window(tr)
    if case == "another_window":
        window.spans = [s for s in window.spans if s[1] < 1.5]
    if case == "no_tracer":
        monkeypatch.setattr(trace, "latest", lambda: None)
    elif case == "no_latest":
        monkeypatch.delattr(trace, "latest")
    else:
        monkeypatch.setattr(trace, "latest", lambda: tr)
    wants_device = metric.endswith("device_ms_per_round")
    if (case == "no_counters" and wants_device) or (
            case == "no_device_track" and not wants_device):
        assert bench.reader(metric)(window) is not None
    else:
        assert bench.reader(metric)(window) is None


def test_window_records_are_on_the_window_clock(monkeypatch):
    tr = _program_tracer()
    monkeypatch.setattr(trace, "latest", lambda: tr)
    device, chunks = tracer.window_records(_window(tr))
    assert device[0][0] == "local/grad"
    assert device[0][1:] == pytest.approx((0.5, 0.6), abs=1e-9)
    assert device[4][1:] == pytest.approx((1.5, 1.6), abs=1e-9)
    assert [c["syncs"] for c in chunks] == [1, 2]
