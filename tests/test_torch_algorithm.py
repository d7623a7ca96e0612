"""Algorithm 1 in the port (repro_torch.core.algorithm) against the JAX
reference (repro.core.algorithm), plus torch twins of the structural claims
of tests/test_algorithm.py.  CPU only: the local step runs the kernel's plain
version.

Tolerance for the round state: rtol 1e-10, atol 1e-12.  The port rounds
every operation of the local step once, like ``repro.kernels.ref``; the
reference's jitted round (a ``lax.scan``) may let XLA CPU contract
``z_hat - eta*(g + c)`` into an FMA, and the two libraries sum the
matrix-vector products and client means in different orders.  Both are
last-ulp effects per operation; three rounds stay far inside 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithm as A
from repro.core import prox as jprox
from repro.data.synthetic import logistic_heterogeneous
from repro.exec import sample_active_masks as j_sample_active_masks
from repro.models import logreg as jlogreg
from repro_torch import interop
from repro_torch.core import algorithm as TA
from repro_torch.core import prox as tprox
from repro_torch.core.metrics import prox_gradient_norm
from repro_torch.data.synthetic import make_round_batches
from repro_torch.exec import sample_active_masks
from repro_torch.models import logreg
from repro_torch.utils import tree as tu

RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture(autouse=True)
def _x64_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _problem(n=8, m=40, d=10, seed=0):
    data = logistic_heterogeneous(n_clients=n, m_per_client=m, d=d, alpha=5,
                                  beta=5, seed=seed)
    s = np.linalg.norm(data.features.reshape(-1, d), axis=1).max()
    data.features = (data.features / s).astype(np.float64)
    data.labels = data.labels.astype(np.float64)
    return data, {"w": np.zeros(d), "b": np.float64(0.0)}


def _assert_state_close(ts, js):
    for k in ("w", "b"):
        np.testing.assert_allclose(ts.x_bar[k].numpy(),
                                   np.asarray(js.x_bar[k]), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(ts.c[k].numpy(), np.asarray(js.c[k]),
                                   rtol=RTOL, atol=ATOL)
    assert int(ts.round) == int(js.round)


@pytest.mark.parametrize("tau", [1, 4])
@pytest.mark.parametrize("batch", [16, None], ids=["minibatch16", "full"])
@pytest.mark.parametrize("with_active", [False, True],
                         ids=["dense", "active"])
@pytest.mark.parametrize("schedule", ["linear", "fixed"])
def test_round_fn_matches_reference(tau, batch, with_active, schedule):
    data, p0 = _problem()
    kw = dict(tau=tau, eta=0.05, eta_g=2.0, prox_schedule=schedule)
    jreg, treg = jprox.L1(lam=0.003), tprox.L1(lam=0.003)
    jrf = jax.jit(A.make_round_fn(A.DProxConfig(**kw), jreg,
                                  jlogreg.make_grad_fn()))
    trf = TA.make_round_fn(TA.DProxConfig(**kw), treg, logreg.make_grad_fn())
    js = A.init_state(jax.tree_util.tree_map(jnp.asarray, p0), 8)
    ts = TA.init_state(interop.params_to_torch(p0, "cpu"), 8)
    rng = np.random.default_rng(1)
    for _ in range(3):
        b = make_round_batches(data, tau, batch, rng)
        act = (sample_active_masks(8, 1, 0.5, rng)[0] if with_active
               else None)
        js, jm = jrf(js, b, None if act is None else jnp.asarray(act))
        ts, tm = trf(ts, b, act)
        _assert_state_close(ts, js)
        assert float(tm["train_loss"]) == pytest.approx(
            float(jm["train_loss"]), rel=1e-6)  # float32 metric
        assert float(tm["drift"]) == pytest.approx(float(jm["drift"]),
                                                   rel=1e-5)


def test_masked_l1_takes_the_prox_path_and_matches_reference():
    data, p0 = _problem(seed=4)
    mask = {"w": True, "b": False}
    kw = dict(tau=3, eta=0.05, eta_g=2.0)
    jreg = jprox.L1(lam=0.01).with_mask(mask)
    treg = tprox.L1(lam=0.01).with_mask(mask)
    jrf = jax.jit(A.make_round_fn(A.DProxConfig(**kw), jreg,
                                  jlogreg.make_grad_fn()))
    trf = TA.make_round_fn(TA.DProxConfig(**kw), treg, logreg.make_grad_fn())
    js = A.init_state(jax.tree_util.tree_map(jnp.asarray, p0), 8)
    ts = TA.init_state(interop.params_to_torch(p0, "cpu"), 8)
    rng = np.random.default_rng(2)
    for _ in range(3):
        b = make_round_batches(data, kw["tau"], None, rng)
        js, _ = jrf(js, b)
        ts, _ = trf(ts, b)
        _assert_state_close(ts, js)


def test_state_round_trips_through_interop():
    data, p0 = _problem()
    js = A.init_state(jax.tree_util.tree_map(jnp.asarray, p0), 8)
    ts = interop.state_to_torch(js, "cpu", torch.float64)
    back = interop.state_to_numpy(ts)
    for k in ("w", "b"):
        np.testing.assert_array_equal(back.x_bar[k], np.asarray(js.x_bar[k]))
        np.testing.assert_array_equal(back.c[k], np.asarray(js.c[k]))
    assert back.round == 0 and ts.round.dtype == torch.int32
    t32 = interop.params_to_torch(p0, "cpu", torch.float32)
    assert t32["w"].dtype == torch.float32


def test_sample_active_masks_match_reference():
    a = sample_active_masks(30, 5, 0.3, np.random.default_rng(7))
    b = j_sample_active_masks(30, 5, 0.3, np.random.default_rng(7))
    np.testing.assert_array_equal(a, b)


# -- torch twins of tests/test_algorithm.py ---------------------------------


def _torch_problem(**kw):
    data, p0 = _problem(**kw)
    return (data, tprox.L1(lam=0.003), logreg.make_grad_fn(),
            interop.params_to_torch(p0, "cpu"))


def test_compact_form_equals_per_client_protocol():
    """Appendix A.1: Eq. (2) == Algorithm 1 message passing."""
    data, reg, grad_fn, params0 = _torch_problem()
    cfg = TA.DProxConfig(tau=4, eta=0.05, eta_g=2.0)
    rng = np.random.default_rng(1)
    state_c = TA.init_state(params0, data.n_clients)
    state_p = TA.init_state(params0, data.n_clients)
    round_fn = TA.make_round_fn(cfg, reg, grad_fn)
    for _ in range(3):
        batches = make_round_batches(data, cfg.tau, 16, rng)
        state_c, _ = round_fn(state_c, batches)
        state_p = TA.run_per_client_round(cfg, reg, grad_fn, state_p, batches)
        np.testing.assert_allclose(state_c.x_bar["w"].numpy(),
                                   state_p.x_bar["w"].numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(state_c.c["w"].numpy(),
                                   state_p.c["w"].numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_correction_terms_average_to_zero():
    """Eq. (A.4): W C^r = 0 for every round r."""
    data, reg, grad_fn, params0 = _torch_problem(seed=3)
    cfg = TA.DProxConfig(tau=5, eta=0.02, eta_g=3.0)
    rng = np.random.default_rng(0)
    state = TA.init_state(params0, data.n_clients)
    round_fn = TA.make_round_fn(cfg, reg, grad_fn)
    for _ in range(5):
        state, _ = round_fn(state, make_round_batches(data, cfg.tau, 8, rng))
        assert float(tu.tree_norm(tu.tree_mean_over_axis0(state.c))) < 1e-12


def test_stationary_point_is_fixed_point():
    """Algorithm 2 / Appendix A.2: with n=1 and full gradients, starting the
    round from x_bar = x* - eta_tilde * grad f(x*) keeps every iterate at
    x*."""
    data, reg, grad_fn, params0 = _torch_problem(n=1, m=60, seed=5)
    d = data.features.shape[-1]
    amat = data.features.reshape(-1, d)
    L = float(np.linalg.eigvalsh(amat.T @ amat / (4 * amat.shape[0]))[-1])
    full_g = logreg.full_gradient_fn(data.features, data.labels,
                                     device="cpu")
    step = 1.0 / L
    x = params0
    for _ in range(8000):
        g = full_g(x)
        x = reg.prox(tu.tree_map(lambda xi, gi: xi - step * gi, x, g), step)
    gnorm = float(prox_gradient_norm(reg, full_g, x, step))
    assert gnorm < 1e-12, f"PGD failed to find stationary point, ||G||={gnorm:.2e}"

    tau, eta_g = 4, 2.0
    cfg = TA.DProxConfig(tau=tau, eta=step / (eta_g * tau), eta_g=eta_g)
    g_star = full_g(x)
    state = TA.DProxState(
        x_bar=tu.tree_map(lambda xi, gi: xi - cfg.eta_tilde * gi, x, g_star),
        c=tu.tree_broadcast_axis0(tu.tree_zeros_like(x), 1),
        round=torch.zeros((), dtype=torch.int32))
    round_fn = TA.make_round_fn(cfg, reg, grad_fn)
    rng = np.random.default_rng(0)
    for r in range(5):
        state, _ = round_fn(state, make_round_batches(data, tau, None, rng))
        out = TA.global_params(reg, cfg, state)
        err = float(tu.tree_norm(tu.tree_sub(out, x)))
        assert err < 1e-10, f"round {r}: drifted {err:.2e} from stationary point"
