"""The port's bare engine, suppliers, problem set-up and simulator options
against the JAX reference (repro_torch.exec / repro_torch.fed vs repro.exec /
repro.fed), plus the torch twin of the prox-PL convergence test of
tests/test_paper_experiments.py.  CPU only.

Tolerances: suppliers and the problem's data are held bitwise (same numpy
draws); trajectories at rtol 1e-10, atol 1e-12 (see
tests/test_torch_algorithm.py) and optimality at rtol 1e-6 (float32 norms);
chunking and ``step`` vs ``run`` bitwise.
"""
import jax
import numpy as np
import pytest
import torch

from benchmarks.common import logreg_problem as j_logreg_problem
from repro.core.algorithm import DProxConfig as JConfig
from repro.data.synthetic import make_round_batches as j_make_round_batches
from repro.exec import ArraySupplier as JArraySupplier
from repro.fed import simulator as jsim
from repro_torch.core.algorithm import DProxConfig
from repro_torch.data.synthetic import make_round_batches
from repro_torch.exec import (ArraySupplier, EngineConfig, RoundEngine,
                              rounds_to_boundary)
from repro_torch.fed import problems
from repro_torch.fed import simulator as tsim


@pytest.fixture(autouse=True)
def _x64_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _assert_opt_close(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        if e > 1e-9:
            assert abs(g - e) <= 1e-6 * e, (g, e)
        else:
            assert g <= 1e-9, (g, e)


def test_logreg_problem_matches_reference():
    jd, _, _, _, jp0, jL = j_logreg_problem(n_clients=6, m=11, d=7)
    td, treg, _, _, tp0, tL = problems.logreg_problem(n_clients=6, m=11, d=7,
                                                      device="cpu")
    assert tL == jL and treg.lam == 0.003
    np.testing.assert_array_equal(td.features, jd.features)
    np.testing.assert_array_equal(td.labels, jd.labels)
    assert tp0["w"].dtype == torch.float64 and tp0["w"].shape == (7,)


def test_smoothness_from_the_gram_matrix_when_rows_are_few():
    """n*m < d: L from A A^T (n*m x n*m) equals L from A^T A."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(3, 4, 50))
    a = feats.reshape(-1, 50)
    exp = float(np.linalg.eigvalsh(a.T @ a / (4 * 12))[-1])
    assert problems.smoothness(feats, "cpu") == pytest.approx(exp, rel=1e-12)
    # with the bias coordinate's column of ones, on both branches
    for f in (feats, feats[..., :3]):
        aug = np.concatenate([f.reshape(-1, f.shape[-1]), np.ones((12, 1))],
                             axis=1)
        exp = float(np.linalg.eigvalsh(aug.T @ aug / (4 * 12))[-1])
        assert problems.smoothness(f, "cpu", bias=True) == pytest.approx(
            exp, rel=1e-12)


def test_synthetic_logreg_satisfies_prox_pl_convergence():
    """Torch twin of tests/test_paper_experiments.py: the sparse-logreg
    problem is prox-PL, so full-gradient DProx converges linearly."""
    data, reg, grad_fn, full_g, params0, L = problems.logreg_problem(
        n_clients=8, m=60, d=12, x64=True, device="cpu")
    tau, eta_g = 5, 3.0
    eta_tilde = 0.5 / L
    cfg = DProxConfig(tau=tau, eta=eta_tilde / (eta_g * tau), eta_g=eta_g)
    h = tsim.run(tsim.DProxAlgorithm(reg, cfg), params0, grad_fn,
                 lambda r, rng: make_round_batches(data, tau, None, rng), 8,
                 1500, reg=reg, eta_tilde=eta_tilde, full_grad_fn=full_g,
                 eval_every=300, device="cpu")
    opt = h.optimality
    assert opt[-1] < 1e-3 * opt[1] or opt[-1] < 1e-8


def test_participation_run_matches_reference():
    """Partial participation: per round the batch draw, then the mask draw,
    from one numpy stream -- the same batches and masks as the reference,
    so the same trajectory."""
    data, reg, grad_fn, full_g, params0, L = j_logreg_problem(
        n_clients=10, m=30, d=8)
    td, treg, tgrad, tfull, tp0, _ = problems.logreg_problem(
        n_clients=10, m=30, d=8, device="cpu")
    kw = dict(tau=3, eta=0.1, eta_g=3.0)
    h = jsim.run(jsim.DProxAlgorithm(reg, JConfig(**kw)), params0, grad_fn,
                 lambda r, rng: j_make_round_batches(data, 3, 7, rng), 10, 12,
                 reg=reg, eta_tilde=0.9, full_grad_fn=full_g, eval_every=4,
                 chunk_rounds=4, participation=0.4)
    t = tsim.run(tsim.DProxAlgorithm(treg, DProxConfig(**kw)), tp0, tgrad,
                 lambda r, rng: make_round_batches(td, 3, 7, rng), 10, 12,
                 reg=treg, eta_tilde=0.9, full_grad_fn=tfull, eval_every=4,
                 chunk_rounds=4, participation=0.4, device="cpu")
    _assert_opt_close(t.optimality, h.optimality)
    for k in ("w", "b"):
        np.testing.assert_allclose(t.extra["final_params"][k].numpy(),
                                   np.asarray(h.extra["final_params"][k]),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("batch", [None, 5])
def test_array_supplier_matches_reference(batch):
    data, *_ = j_logreg_problem(n_clients=4, m=9, d=3)
    js = JArraySupplier.from_dataset(data, 2, batch, seed=3)
    host = ArraySupplier.from_dataset(data, 2, batch, seed=3)
    dev = ArraySupplier.from_dataset(data, 2, batch, seed=3,
                                     device_cache=True, device="cpu")
    for r in (0, 5):
        exp = js.sample_round(r)
        for got in (host.sample_round(r), dev.sample_round(r)):
            for k in exp:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(exp[k]))
    exp = js.sample_chunk(2, 3)
    got = dev.sample_chunk(2, 3)
    for k in exp:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(exp[k]))
    if batch is None:  # full batch: a view of the cache, never a copy
        assert got["a"].stride()[0] == 0 and got["a"].stride()[2] == 0


def test_engine_chunk_supplier_step_and_boundaries():
    data, reg, grad_fn, _, params0, L = problems.logreg_problem(
        n_clients=5, m=12, d=4, device="cpu")
    alg = tsim.DProxAlgorithm(reg, DProxConfig(tau=2, eta=0.1, eta_g=3.0))
    sup = ArraySupplier.from_dataset(data, 2, 4, seed=1, device_cache=True,
                                     device="cpu")
    states = []
    for chunk in (1, 3):
        eng = RoundEngine(alg, grad_fn, 5, EngineConfig(chunk_rounds=chunk),
                          device="cpu")
        s, m = eng.run(eng.init(params0), sup, 7)
        assert len(m["train_loss"]) == len(m["drift"]) == 7
        states.append(s)
    for k in ("w", "b"):
        assert torch.equal(states[0].x_bar[k], states[1].x_bar[k])
        assert torch.equal(states[0].c[k], states[1].c[k])
    eng = RoundEngine(alg, grad_fn, 5, device="cpu")
    s1, info = eng.step(eng.init(params0), sup.sample_round(0))
    s2, _ = eng.run(eng.init(params0), sup, 1)
    assert torch.equal(s1.x_bar["w"], s2.x_bar["w"])
    assert set(info) == {"train_loss", "drift"}
    assert [rounds_to_boundary(r, 4, 10) for r in (0, 3, 8)] == [4, 1, 2]
    with pytest.raises(ValueError, match="chunk_rounds"):
        RoundEngine(alg, grad_fn, 5, EngineConfig(chunk_rounds=0),
                    device="cpu")
