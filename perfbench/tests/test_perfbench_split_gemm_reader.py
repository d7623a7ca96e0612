"""The reader of ``kernel.split_gemm_calls_per_round`` on a hand-built
window of the program's tracer: the ``split_gemms`` counter of the chunk
spans, a round; ``None`` where the chunks carry no such counter (a program
without the kernel) or the program keeps no tracer."""
import _pbpath  # noqa: F401
import pytest

from pb import bench, measure
from repro_torch.obs import trace

METRIC = "kernel.split_gemm_calls_per_round"
ROUNDS = 8  # two chunks of 4
BASE = 100.0  # the program's clock at the window's start


def _window(launches):
    """The program's tracer with two chunks over [0.5, 1.5] and [1.5, 2.5]
    of the window, each carrying ``launches[k]`` (no counter for None), and
    the ``Trace`` the harness builds from its host spans."""
    tr = trace.Tracer("perfbench")
    for k, (c0, c1) in enumerate([(0.5, 1.5), (1.5, 2.5)]):
        args = {"start_round": 4 * k, "rounds": 4, "syncs": 1, "mallocs": 0,
                "alloc_retries": 0}
        if launches[k] is not None:
            args["split_gemms"] = launches[k]
        tr._record("exec/chunk", "exec", BASE + c0, BASE + c1, args)
    wire = tr.export_wire()
    spans = [(wire["names"][i], a - BASE, b - BASE) for i, a, b in
             zip(wire["name_ix"], wire["t0"], wire["t1"])]
    return tr, measure.Trace(window_s=2.6, rounds=ROUNDS, kernels=[],
                             spans=spans, costs={})


@pytest.mark.parametrize("launches,want", [
    ((1392, 1392), 348.0),  # the stablelm cell: 4 x 87 products a round
    ((0, 0), 0.0),          # a model with no float32 product on the card
    ((1392, 1044), 304.5),
])
def test_reader_counts_the_launches_a_round(launches, want, monkeypatch):
    tr, window = _window(launches)
    monkeypatch.setattr(trace, "latest", lambda: tr)
    assert bench.reader(METRIC)(window) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("case", ["program_without_counter",
                                  "one_chunk_without_counter", "no_tracer"])
def test_reader_gives_none_without_the_counter(case, monkeypatch):
    launches = {"program_without_counter": (None, None),
                "one_chunk_without_counter": (1392, None),
                "no_tracer": (1392, 1392)}[case]
    tr, window = _window(launches)
    monkeypatch.setattr(trace, "latest",
                        lambda: None if case == "no_tracer" else tr)
    assert bench.reader(METRIC)(window) is None
