"""``correct`` on the CPU at tiny sizes, with the timed path broken
underneath: the rest of a run fails once for each fault a training cell
can have -- a step that returns its state unchanged, and half of each
batch left out (the mean taken over the rest).  The look for a card is
skipped: these run ``bench.run_cell`` on the CPU."""
import _pbpath
import pytest
import torch

from pb import bench

CELLS, SEED, _run = _pbpath.CELLS, _pbpath.SEED, _pbpath.run_tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_fails(name, monkeypatch):
    from repro_torch.exec import RoundEngine

    real = RoundEngine._round

    def stuck(self, state, batches, active):
        _, info = real(self, state, batches, active)
        return state, info

    monkeypatch.setattr(RoundEngine, "_round", stuck)
    result = _run(name)
    assert not result["correct"]
    if "dx_gap" in result["checks"]:
        assert result["checks"]["dx_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS)
def test_half_batch_fails(name, monkeypatch):
    real = bench.family

    def family(kind):
        fam = real(kind)

        class Half:
            def __getattr__(self, attr):
                return getattr(fam, attr)

            @staticmethod
            def port_grad_fn(cfg):
                fn = fam.port_grad_fn(cfg)
                return lambda p, b: fn(p, {k: v[: v.shape[0] // 2]
                                           for k, v in b.items()})

        return Half()

    monkeypatch.setattr(bench, "family", family)
    assert not _run(name)["correct"]
