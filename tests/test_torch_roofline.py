"""The port's roofline (repro_torch.roofline.analysis) against the JAX
reference's (repro.roofline.analysis), and the wire-model diff of
``obs.report``:

  * the wire term -- ``WireModel.seconds``, ``uplink_nbytes`` (all three
    encodings and the error), ``chunk_times`` and ``crossover_ratio``
    (``inf`` and ``0.0`` included) -- bitwise the reference's over a grid;
  * the useful-work yardstick -- ``analytic_param_counts`` and
    ``model_flops_for`` for the ten architectures x the four shapes,
    exactly the reference's, from the port's ``meta`` params structure and
    the reference's ``jax.eval_shape``;
  * ``overlap_report(doc, model=WireModel(...))``, its text and the
    ``--bw`` CLI equal to the reference's on the same trace document.
"""
import itertools
import math

import jax
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro.obs import report as jreport
from repro.roofline import analysis as J
from repro_torch.configs import base, registry
from repro_torch.obs import report, trace
from repro_torch.roofline import analysis as A


def _same(a, b) -> bool:
    """Bitwise float equality (NaN-free), infinities included."""
    return math.copysign(1.0, a) == math.copysign(1.0, b) and (
        a == b or (math.isnan(a) and math.isnan(b)))


def test_constants():
    assert (A.WIRE_BW, A.WIRE_LATENCY, A.SPARSE_INDEX_OVERHEAD) == (
        J.WIRE_BW, J.WIRE_LATENCY, J.SPARSE_INDEX_OVERHEAD)
    # NVIDIA H100 80GB HBM3 spec-sheet peaks
    assert (A.PEAK_FLOPS, A.HBM_BW) == (989e12, 3.35e12)


BWS = (1e6, 1e9, 12.5e9, 3.0e7)
LATENCIES = (0.0, 50e-6, 1.3e-3)
NBYTES = (0, 1, 168, 4096.5, 3_596_608, 1e12)


@pytest.mark.parametrize("bw,latency", list(itertools.product(BWS,
                                                              LATENCIES)))
def test_wire_model_seconds_is_the_references(bw, latency):
    m, jm = A.WireModel(bw=bw, latency_s=latency), J.WireModel(
        bw=bw, latency_s=latency)
    for n in NBYTES:
        assert _same(m.seconds(n), jm.seconds(n))
    assert A.WireModel() == A.WireModel(bw=A.WIRE_BW,
                                        latency_s=A.WIRE_LATENCY)


@pytest.mark.parametrize("encoding", ["dense", "sparse", "palette"])
def test_uplink_nbytes_is_the_references(encoding):
    for dense, ratio, over in itertools.product(
            (0.0, 168.0, 899_152.0, 3.3e9), (0.01, 0.1, 0.25, 0.5, 0.7, 1.0),
            (0.0, 0.5, 1.0)):
        got = A.uplink_nbytes(dense, ratio, encoding=encoding,
                              index_overhead=over)
        assert _same(got, J.uplink_nbytes(dense, ratio, encoding=encoding,
                                          index_overhead=over))
    assert _same(A.uplink_nbytes(1000, 0.3, encoding=encoding),
                 J.uplink_nbytes(1000, 0.3, encoding=encoding))


def test_uplink_nbytes_refuses_an_unknown_encoding():
    with pytest.raises(ValueError) as got:
        A.uplink_nbytes(10.0, 0.5, encoding="zstd")
    with pytest.raises(ValueError) as ref:
        J.uplink_nbytes(10.0, 0.5, encoding="zstd")
    assert str(got.value) == str(ref.value)


def test_chunk_times_is_the_references():
    grid = (0.0, 1e-6, 0.004, 0.25, 1.5, 7.0)
    for c, w in itertools.product(grid, grid):
        got, ref = A.chunk_times(c, w), J.chunk_times(c, w)
        assert list(got) == list(ref)
        assert all(_same(got[k], ref[k]) for k in got)


@pytest.mark.parametrize("encoding", ["dense", "sparse", "palette"])
def test_crossover_ratio_is_the_references(encoding):
    seen = set()
    for compute, dense, bw, latency in itertools.product(
            (0.0, 20e-6, 1e-4, 0.003, 0.02, 1.0), (168.0, 1e5, 1e8),
            (1e6, 1e9), (0.0, 50e-6)):
        got = A.crossover_ratio(compute, dense, A.WireModel(bw, latency),
                                encoding=encoding)
        ref = J.crossover_ratio(compute, dense, J.WireModel(bw, latency),
                                encoding=encoding)
        assert _same(got, ref), (compute, dense, bw, latency)
        seen.add("inf" if math.isinf(got) else "0" if got == 0.0
                 else "finite")
    # the default model, and both ends of the range, are exercised
    assert _same(A.crossover_ratio(0.01, 1e9, encoding=encoding),
                 J.crossover_ratio(0.01, 1e9, encoding=encoding))
    assert {"inf", "0"} <= seen
    if encoding != "dense":
        assert "finite" in seen


def _jax_struct(cfg):
    return jax.eval_shape(lambda k: JT.init_model(k, cfg)[0],
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_model_flops_are_the_references(arch):
    cfg, jcfg = registry.get(arch), jreg.get(arch)
    struct = A.abstract_params(cfg)
    assert all(t.device.type == "meta"
               for t in jax.tree_util.tree_leaves(
                   struct, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    jstruct = _jax_struct(jcfg)
    counts = A.analytic_param_counts(cfg, struct)
    assert counts == J.analytic_param_counts(jcfg, jstruct)
    assert counts[1] <= counts[0]
    assert list(base.SHAPES) == list(jbase.SHAPES)
    for name, shape in base.SHAPES.items():
        for tau in (1, 4):
            got = A.model_flops_for(cfg, shape, struct, tau=tau)
            ref = J.model_flops_for(jcfg, jbase.SHAPES[name], jstruct,
                                    tau=tau)
            assert _same(got, ref), (name, tau)


def _doc(workers=2):
    """A merged trace of ``workers`` worker timelines: four chunks each,
    the ships of later chunks overlapping the next chunk's compute."""
    bundles = []
    for w in range(workers):
        tr = trace.Tracer(f"worker{w}", capacity=64)
        tr.pid = 1000 + w
        t = 50.0 + 0.013 * w
        for k in range(4):
            c1 = t + 0.1 + 0.01 * k
            tr._record("exec/chunk", "exec", t, c1,
                       {"start_round": 8 * k, "rounds": 8})
            tr._record("uplink/wait", "uplink", c1 - 0.004 * w, c1,
                       {"start_round": 8 * k})
            tr._record("uplink/ship", "uplink", c1 - 0.002, c1 + 0.06 + w,
                       {"start_round": 8 * k, "nbytes": 4000 * (k + 1)})
            t = c1
        bundles.append(tr.export_wire())
    return trace.to_chrome(bundles)


@pytest.mark.parametrize("bw,latency", [(1e9, 0.0), (1e5, 50e-6),
                                        (2.5e3, 0.01)])
def test_overlap_report_with_the_wire_model_is_the_references(
        bw, latency, tmp_path, capsys):
    doc = _doc()
    got = report.overlap_report(doc, model=A.WireModel(bw, latency),
                                compute_ref_s=0.09)
    ref = jreport.overlap_report(doc, model=J.WireModel(bw, latency),
                                 compute_ref_s=0.09)
    assert got == ref
    assert got["roofline"]["predicted"] == A.chunk_times(
        got["roofline"]["per_chunk_compute_s"],
        got["roofline"]["per_chunk_wire_s"])
    assert report.format_report(got) == jreport.format_report(ref)
    path = tmp_path / "trace.json"
    trace.write_chrome(doc, str(path))
    argv = [str(path), "--bw", repr(bw), "--latency", repr(latency)]
    assert report.main(argv) == 0
    mine = capsys.readouterr().out
    assert jreport.main(argv) == 0
    assert mine == capsys.readouterr().out
    assert "roofline: predicted hidden=" in mine


def test_no_model_no_roofline_block():
    doc = _doc(workers=1)
    got = report.overlap_report(doc)
    assert "roofline" not in got and got == jreport.overlap_report(doc)
    assert all("wire_model_s" not in r for r in got["chunks"])
