"""``correct`` on the CPU at tiny sizes: a sound run of each cell passes
(traced too), and the control, the reference in TF32 put in the
program's place, fails the cell's limits.  The look for a card is
skipped: these run ``bench.run_cell`` on the CPU."""
import _pbpath
import pytest
import torch

from pb import bench, check

CELLS, SEED, _run = _pbpath.CELLS, _pbpath.SEED, _pbpath.run_tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"setup_s", "round_s", "peak_mem_gb"}


def test_traced_run_reads_the_spans():
    result = _run("fig4-cnn.dprox-t10", trace=True)
    assert result["correct"]
    # no device on the CPU: only the span reader has something to read
    assert set(result["metrics"]) == {"engine.host_ms_per_round"}
    assert result["metrics"]["engine.host_ms_per_round"]["value"] > 0
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = _pbpath.tiny(_pbpath.load(name))
    fam = bench.family(cell.config["family"])
    from pb import program, spec, traffic

    prog = program.Program(cell, fam, fam.init_params(cell.config, SEED,
                                                      "cpu"),
                           traffic.make(cell.traffic, cell.config, SEED),
                           SEED, "cpu")
    prog.check_rounds(lambda: fam.init_params(cell.config, SEED, "cpu"))
    batches = prog.feed.reference_batches(spec.checked_rounds(cell.traffic))
    prog.close()
    exact = bench.reference_readings(cell, fam, batches, SEED, "cpu")
    tf32 = bench.reference_readings(cell, fam, batches, SEED, "cpu",
                                    precision="tf32")
    correct, checks = check.judge(check.gaps(tf32, exact),
                                  cell.traffic["limits"])
    assert not correct, checks
