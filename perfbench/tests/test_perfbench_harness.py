"""The harness's yardstick and its lookup, on the CPU: operation and byte
counts against hand counts, cells and metrics found by the names in
``BENCHMARK.json``, and the imports the benchmark may not make."""
import ast
import json
import math
import re

import _pbpath
import pytest

from families import cnn as fam_cnn
from families import transformer as fam_lm
from pb import bench, costs, spec
from reference import transformer as ref_lm

BENCH = json.loads((_pbpath.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SOURCES = sorted(p for p in _pbpath.PERFBENCH.rglob("*.py"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


# -- counts -------------------------------------------------------------------

def test_stablelm_d4_parameters():
    cfg = spec.cell("stablelm-1.6b.dprox-dense").config
    # 4 x (2 norms x 2048 + 4 x 2048^2 + 3 x 2048 x 5632) + 100352 x 2048
    # + the final norm
    assert ref_lm.count_params(cfg) == 411_060_224
    assert sum(math.prod(s) for _, s, _ in fam_lm._leaves(cfg)) \
        == 411_060_224


def test_cnn_parameters_and_flops():
    cfg = _pbpath.load("fig4-cnn.dprox-t10").config
    assert fam_cnn.n_params(cfg) == cfg["n_params"] == 112_394
    # multiply-adds: conv1 28*28*32*9, conv2 14*14*32*288, fc 1568*64 +
    # 64*32 + 32*10; 6 per MAC less conv1's input gradient (2 per MAC)
    macs = [225_792, 1_806_336, 100_352, 2_048, 320]
    want = 6 * sum(macs) - 2 * macs[0]
    assert costs.cnn_train_flops_per_example(
        cfg["image"], cfg["conv_channels"], cfg["kernel"], cfg["pool"],
        cfg["dense"]) == want == 12_357_504
    c = fam_cnn.costs_of(cfg, _pbpath.load("fig4-cnn.dprox-t10").traffic)
    assert c["model_flops_per_round"] == want * 10 * 10 * 10


def test_stablelm_round_flops():
    cell = spec.cell("stablelm-1.6b.dprox-dense")
    c = fam_lm.costs_of(cell.config, cell.traffic)
    tokens = 4 * 4 * 4 * 128
    attn = 12 * (128 * 129 // 2) * 32 * 64 * 4 * 64
    assert c["model_flops_per_round"] == 6 * 411_060_224 * tokens + attn
    # kernel 1: 5 planes of 4 clients x N float32, tau = 4 steps a round
    assert c["k1_bound_s_per_round"] == pytest.approx(
        4 * 5 * 4 * 411_060_224 * 4 / 3.35e12, rel=1e-12)


@pytest.mark.parametrize("fn,want_ops,want_bytes", [
    # (16, 128, 32/32, 64) f32: q, k, v, out + lse; 4 ops a causal pair
    (costs.flash_forward, 4 * 8256 * 32 * 64 * 16,
     4 * (4 * 16 * 128 * 32 * 64 + 16 * 32 * 128)),
    # backward: q, k, v, out, d_out + lse read, dq, dk, dv written
    (costs.flash_backward, 8 * 8256 * 32 * 64 * 16,
     4 * (8 * 16 * 128 * 32 * 64 + 16 * 32 * 128)),
])
def test_flash_counts(fn, want_ops, want_bytes):
    assert fn(16, 128, 32, 32, 64) == (want_ops, want_bytes)


def test_bound_is_the_larger():
    assert costs.bound_s(495e12, 1.0) == pytest.approx(1.0)
    assert costs.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


# -- lookup by name -----------------------------------------------------------

@pytest.mark.parametrize("name", _pbpath.CELLS)
def test_cells_found_by_name(name):
    """Every cell, those held back included, from its files."""
    cell = _pbpath.load(name)
    assert cell.chips == 1
    assert bench.family(cell.config["family"]).Feed
    assert {"loss_gap", "grad1_gap"} <= set(cell.traffic["limits"]) \
        <= {"loss_gap", "grad1_gap", "dx_gap"}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "round_s",
                                                    "peak_mem_gb"}
    assert cell.per_layer and all(m["moves"] == "round_s"
                                  for m in cell.per_layer)


@pytest.mark.parametrize("metric", sorted(
    {m["name"] for m in BENCH["per_layer"]}
    | {p.stem for p in (_pbpath.PERFBENCH / "metrics").glob("*.py")}))
def test_metric_readers_found_by_name(metric):
    """Every metric of ``BENCHMARK.json`` has its reader, and every reader
    (those of the cells held back included) loads."""
    assert callable(bench.reader(metric))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        assert (_pbpath.ROOT / c["file"]).is_file()
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


# -- imports ------------------------------------------------------------------

def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(_pbpath.PERFBENCH)))
def test_no_jax_and_no_jax_package(path):
    """Top-level names compared whole: ``repro_torch`` is allowed,
    ``repro`` is not."""
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted(
    (_pbpath.PERFBENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "contextlib", "math", "numpy",
                              "torch", "reference"}
