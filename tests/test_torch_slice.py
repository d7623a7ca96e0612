"""The port's main path end to end against the JAX reference: the paper's
Fig. 2 experiment through ``repro_torch.fed.simulator.run`` vs
``repro.fed.simulator.run``.  CPU only (the local step runs the kernel's
plain version).

Tolerance for the optimality sequences: rtol 1e-6 wherever the reference
value is above 1e-9, and both below 1e-9 elsewhere.  The optimality is a
float32 norm ratio in both packages (``tree_norm`` reduces in float32), so a
few float32 ulps (~1e-7) of difference are expected; the float64
trajectories themselves differ only by reduction order and XLA's FMA
contraction.  Chunking is held bitwise.
"""
import jax
import numpy as np
import pytest
import torch

from benchmarks.common import logreg_problem as j_logreg_problem
from repro.core.algorithm import DProxConfig as JConfig
from repro.data.synthetic import make_round_batches as j_make_round_batches
from repro.fed import simulator as jsim
from repro_torch.core.algorithm import DProxConfig
from repro_torch.data.synthetic import make_round_batches
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


def _fig2_port(tau, rounds, every, chunk_rounds):
    data, reg, grad_fn, full_g, params0, L = problems.logreg_problem(
        device="cpu")
    eta_g, eta_tilde = 15.0, 0.5 / L
    cfg = DProxConfig(tau=tau, eta=eta_tilde / (eta_g * tau), eta_g=eta_g)
    return tsim.run(tsim.DProxAlgorithm(reg, cfg), params0, grad_fn,
                    lambda r, rng: make_round_batches(data, tau, None, rng),
                    30, rounds, reg=reg, eta_tilde=eta_tilde,
                    full_grad_fn=full_g, eval_every=every,
                    chunk_rounds=chunk_rounds, device="cpu")


@pytest.mark.parametrize("tau", [1, 10])
def test_fig2_optimality_matches_reference_and_chunking_is_bitwise(tau):
    """The paper's Fig. 2 problem: n 30, m 100, d 20, float64, eta_g 15,
    eta_tilde = 0.5/L, 300 rounds evaluated every 30."""
    data, reg, grad_fn, full_g, params0, L = j_logreg_problem()
    eta_g, eta_tilde = 15.0, 0.5 / L
    cfg = JConfig(tau=tau, eta=eta_tilde / (eta_g * tau), eta_g=eta_g)
    h = jsim.run(jsim.DProxAlgorithm(reg, cfg), params0, grad_fn,
                 lambda r, rng: j_make_round_batches(data, tau, None, rng),
                 30, 300, reg=reg, eta_tilde=eta_tilde, full_grad_fn=full_g,
                 eval_every=30)
    t8 = _fig2_port(tau, 300, 30, chunk_rounds=8)
    assert t8.rounds == h.rounds
    _assert_opt_close(t8.optimality, h.optimality)
    assert t8.optimality[-1] < 1e-2 * t8.optimality[0]
    np.testing.assert_allclose(t8.loss, h.loss, rtol=1e-6)
    t1 = _fig2_port(tau, 300, 30, chunk_rounds=1)
    assert t1.optimality == t8.optimality and t1.loss == t8.loss
    for k in ("w", "b"):
        assert torch.equal(t1.extra["final_params"][k],
                           t8.extra["final_params"][k])
