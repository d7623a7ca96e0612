"""Puts ``perfbench/`` and the checkout's ``src/`` on ``sys.path`` for the
benchmark's CPU tests, and holds their shared tiny cells."""
import sys
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
for p in (str(ROOT / "src"), str(PERFBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the program's smoke sizes (src/repro_torch/configs/stablelm_1_6b.py
# SMOKE), and traffic a CPU runs in seconds
TINY_LM = dict(n_layers=2, d_model=128, d_ff=352, vocab=512, num_heads=4,
               num_kv_heads=4, head_dim=32)
TINY_LM_TRAFFIC = dict(clients=2, batch=2, seq=16, tau=2, chunk=2,
                       seqs_per_client=8)
TINY_CNN_TRAFFIC = dict(train_images=400, tau=2, batch=2, chunk=2)


# the cells the benchmark holds back (PERF.md section 7): their files are
# kept, and the CPU tests still run them
HELD_BACK = {
    "fig4-cnn.dprox-t10": ("fig4-cnn", "fig4-cnn.json", "dprox-t10"),
    "stablelm-1.6b.dprox-topk": ("stablelm-1.6b-d4", "stablelm-1.6b-d4.json",
                                 "dprox-topk"),
    "fig4-cnn.fedda-t10": ("fig4-cnn", "fig4-cnn.json", "fedda-t10"),
}


def load(name):
    """A cell of ``BENCHMARK.json``, or one held back, from its files."""
    from pb import spec

    if name in HELD_BACK:
        config, file, traffic = HELD_BACK[name]
        return spec.make_cell(spec.load_benchmark(), name, 1, config,
                              PERFBENCH / "configs" / file, traffic)
    return spec.cell(name)


def tiny(cell):
    """``cell`` shrunk in place to the sizes above; returns it."""
    if cell.config["family"] == "transformer":
        cell.config.update(TINY_LM)
        cell.traffic.update(TINY_LM_TRAFFIC)
    else:
        cell.traffic.update(TINY_CNN_TRAFFIC)
    return cell


CELLS = ("stablelm-1.6b.dprox-dense", "stablelm-1.6b.dprox-topk",
         "fig4-cnn.dprox-t10", "fig4-cnn.fedda-t10")
SEED = 2**31 + 77


def run_tiny(name, trace=False):
    """One run of the cell ``name``, shrunk, on the CPU: its result."""
    import time

    from pb import bench

    result, _ = bench.run_cell(tiny(load(name)), SEED, 0.2, trace,
                               "cpu", time.perf_counter())
    return result
