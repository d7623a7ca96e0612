"""The six baselines in the port (repro_torch.core.baselines) against the JAX
reference (repro.core.baselines), plus torch twins of the baseline contracts
of tests/test_exec.py, tests/test_comm.py and tests/test_algorithm.py.  CPU
only.

Tolerances:
  * the round state against the reference: rtol 1e-10, atol 1e-12, as for
    DProx (tests/test_torch_algorithm.py): the port rounds each operation
    once, XLA may contract an update into an FMA, and the two libraries sum
    the client means in different orders -- last-ulp effects per round.
    FastFedDA's step size eta0 / sqrt(k + 1) is a float32 scalar in both
    packages, but XLA rewrites the division to ``eta0 * rsqrt(k + 1)`` and
    its CPU rsqrt is not correctly rounded (it differs from the correctly
    rounded value by an ulp at about one k in eight), which moves the state
    by ~1e-8 relative.  So the comparison replays the reference's step
    sizes (as the compressed paths replay its draws), and
    ``test_fast_fedda_step_size_is_float32`` holds the port's own step to
    the correctly rounded float32 quotient and within two ulps of
    XLA's;
  * the float32 train loss: rel 1e-6;
  * the optimality sequences of the Fig. 3 runs: rtol 1e-6 above 1e-9
    (float32 norms, as in tests/test_torch_slice.py);
  * DProx == FedDA at tau = 1: atol 1e-12 on x_bar (the reference's
    tests/test_algorithm.py:86);
  * the port against itself (chunking): bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import logreg_problem as j_logreg_problem
from repro import comm as jcomm
from repro.core import baselines as JB
from repro.core.algorithm import DProxConfig as JConfig
from repro.data.synthetic import make_round_batches as j_make_round_batches
from repro.exec import EngineConfig as JEngineConfig
from repro.exec import RoundEngine as JRoundEngine
from repro.fed import simulator as jsim
from repro_torch import comm, interop
from repro_torch.core import baselines as TB
from repro_torch.core.algorithm import DProxConfig
from repro_torch.data.synthetic import make_round_batches
from repro_torch.exec import ArraySupplier, EngineConfig, RoundEngine
from repro_torch.fed import problems
from repro_torch.fed import simulator as tsim
from repro_torch.kernels import fused_prox
from repro_torch.utils import tree as tu

RTOL, ATOL = 1e-10, 1e-12
NAMES = ["fedavg", "fedmid", "fedda", "fast_fedda", "scaffold", "fedprox"]


@pytest.fixture(autouse=True)
def _x64_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _make(pkg, name, reg, tau, eta, eta_g):
    """One baseline with Fig. 2's step sizes (``fig2_fullgrad.py:33-42``):
    FedDA at (eta, eta_g), the primal ones at the global step eta * eta_g."""
    step = eta * eta_g
    return {
        "fedavg": lambda: pkg.FedAvg(tau, step),
        "fedmid": lambda: pkg.FedMid(reg, tau, step, 1.0),
        "fedda": lambda: pkg.FedDA(reg, tau, eta, eta_g),
        "fast_fedda": lambda: pkg.FastFedDA(reg, tau, eta0=step,
                                            eta_g=eta_g),
        "scaffold": lambda: pkg.Scaffold(reg, tau, step),
        "fedprox": lambda: pkg.FedProx(reg, tau, step, mu=0.1),
    }[name]()


def _fig2(tau=10):
    """The Fig. 2 problem in both packages (n 30, m 100, d 20, float64)."""
    jd, jreg, jgrad, _, jp0, L = j_logreg_problem()
    data, reg, grad_fn, _, p0, L_t = problems.logreg_problem(device="cpu")
    assert L == L_t
    eta_g, eta_tilde = 15.0, 0.5 / L
    eta = eta_tilde / (eta_g * tau)
    return (jd, jreg, jgrad, jp0), (data, reg, grad_fn, p0), (eta, eta_g)


def _xla_step(eta0: float, tau: int):
    """The reference's FastFedDA step size as XLA computes it, for
    (round, t)."""
    f = jax.jit(lambda r, t: eta0 / jnp.sqrt(
        r.astype(jnp.float32) * tau + t.astype(jnp.float32) + 1.0))
    return lambda r, t: np.float32(f(jnp.int32(r), jnp.int32(t)))


def _replaying(talg):
    """``talg`` (a port FastFedDA) with the reference's step sizes for the
    first 20 rounds (a table indexed by the round counter, so the engine's
    shape-only pass reads no data)."""
    step = _xla_step(talg.eta0, talg.tau)
    table = [step(r, t) for r in range(20) for t in range(talg.tau)]

    class Replay(TB.FastFedDA):
        def step_size(self, round_, t):
            steps = torch.tensor(table, dtype=torch.float32)
            return torch.take(steps, round_.to(torch.int64) * self.tau + t)

    return Replay(talg.reg, talg.tau, eta0=talg.eta0, eta_g=talg.eta_g)


def _assert_state_close(ts, js):
    got = interop.baseline_state_to_numpy(ts)
    assert type(got).__name__ == type(js).__name__
    for f in js._fields:
        if f == "round":
            assert int(got.round) == int(js.round)
            continue
        a = jax.tree_util.tree_leaves(getattr(js, f))
        b = tu.tree_leaves(getattr(got, f))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, np.asarray(x), rtol=RTOL,
                                       atol=ATOL, err_msg=f)


@pytest.mark.parametrize("name", NAMES)
def test_baseline_matches_reference_on_fig2(name):
    """5 rounds at tau 10 from the reference's initial state, carried in
    through the interop converters; then the reference's round-2 state
    carried in and 3 rounds on from there."""
    tau = 10
    (jd, jreg, jgrad, jp0), (data, reg, grad_fn, p0), (eta, eta_g) = \
        _fig2(tau)
    jalg, talg = (_make(JB, name, jreg, tau, eta, eta_g),
                  _make(TB, name, reg, tau, eta, eta_g))
    assert (talg.name, talg.uplink_vectors, talg.downlink_vectors) == (
        jalg.name, jalg.uplink_vectors, jalg.downlink_vectors)
    assert talg.state_roles() == jalg.state_roles()
    if name == "fast_fedda":
        talg = _replaying(talg)
    jrf = jax.jit(jalg.make_round_fn(jgrad))
    trf = talg.make_round_fn(grad_fn)
    js = jalg.init(jp0, 30)
    ts = interop.baseline_state_to_torch(js, "cpu")
    rng = np.random.default_rng(0)
    saved = None
    batches = []
    for r in range(5):
        b = make_round_batches(data, tau, None, rng)
        batches.append(b)
        js, jm = jrf(js, b)
        ts, tm = trf(ts, b)
        _assert_state_close(ts, js)
        assert float(tm["train_loss"]) == pytest.approx(
            float(jm["train_loss"]), rel=1e-6)
        if r == 1:
            saved = js
    ts = interop.baseline_state_to_torch(saved, "cpu")
    assert int(ts.round) == 2
    js = saved
    for b in batches[2:]:
        js, _ = jrf(js, b)
        ts, _ = trf(ts, b)
    _assert_state_close(ts, js)
    np.testing.assert_allclose(
        interop.params_to_numpy(talg.global_params(ts))["w"],
        np.asarray(jalg.global_params(js)["w"]), rtol=RTOL, atol=ATOL)


def test_fast_fedda_step_size_is_float32():
    """The port's decaying step eta0 / sqrt(k + 1) is the correctly rounded
    float32 quotient, within two ulps of XLA's; with the reference's steps
    replayed a round matches it at the tolerance, and the same round with
    the step in float64 does not (so the comparison would see a float64
    step)."""
    tau = 10
    (jd, jreg, jgrad, jp0), (data, reg, grad_fn, p0), (eta, eta_g) = \
        _fig2(tau)
    jalg = _make(JB, "fast_fedda", jreg, tau, eta, eta_g)
    talg = _make(TB, "fast_fedda", reg, tau, eta, eta_g)
    xla = _xla_step(talg.eta0, tau)
    for r in range(0, 400, 7):
        for t in range(tau):
            got = talg.step_size(torch.tensor(r, dtype=torch.int32), t)
            k = np.float32(r) * np.float32(tau) + np.float32(t)
            exp = np.float32(talg.eta0) / np.sqrt(k + np.float32(1.0))
            assert got.dtype == torch.float32 and got.numpy() == exp
            assert abs(got.numpy() - xla(r, t)) <= 2 * np.spacing(exp)

    class Float64Step(TB.FastFedDA):
        def step_size(self, round_, t):
            return self.eta0 / torch.sqrt(
                round_.to(torch.float64) * self.tau + t + 1.0)

    t64 = Float64Step(reg, tau, eta0=talg.eta0, eta_g=eta_g)
    js = jalg.init(jp0, 30)
    ts = interop.baseline_state_to_torch(js, "cpu")
    b = make_round_batches(data, tau, None, np.random.default_rng(0))
    js, _ = jax.jit(jalg.make_round_fn(jgrad))(js, b)
    ts64, _ = t64.make_round_fn(grad_fn)(ts, b)
    ts, _ = _replaying(talg).make_round_fn(grad_fn)(ts, b)
    _assert_state_close(ts, js)
    ref = np.asarray(js.x_bar["w"])
    off = np.abs(ts64.x_bar["w"].numpy() - ref)
    assert np.any(off > ATOL + RTOL * np.abs(ref))


@pytest.mark.parametrize("name", NAMES)
def test_baseline_through_engine_chunked_is_unchunked_bitwise(name):
    """The twin of tests/test_exec.py:344: every baseline runs through the
    engine; chunk_rounds 3 == chunk_rounds 1 bitwise."""
    (_, _, _, _), (data, reg, grad_fn, p0), (eta, eta_g) = _fig2(3)
    alg = _make(TB, name, reg, 3, eta, eta_g)
    sup = ArraySupplier.from_dataset(data, 3, 8, seed=4)
    out = []
    for chunk in (3, 1):
        eng = RoundEngine(alg, grad_fn, 30, EngineConfig(chunk_rounds=chunk),
                          device="cpu")
        state, m = eng.run(eng.init(p0), sup, 6, seed=0)
        assert len(m["train_loss"]) == 6
        assert np.isfinite(m["train_loss"]).all()
        out.append((state, m))
    (s3, m3), (s1, m1) = out
    assert m3["train_loss"] == m1["train_loss"]
    for a, b in zip(tu.tree_leaves(s3), tu.tree_leaves(s1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,vectors", [("fast_fedda", 2), ("scaffold", 2),
                                          ("fedda", 1)])
def test_two_vector_baselines_through_topk(name, vectors):
    """The twin of tests/test_comm.py:231: the uplink carries the declared
    number of d-vectors; through per-leaf TopK(0.5) the wire bytes and the
    state after 3 rounds equal the reference's engine."""
    tau = 3
    (jd, jreg, jgrad, jp0), (data, reg, grad_fn, p0), (eta, eta_g) = \
        _fig2(tau)
    jalg, talg = (_make(JB, name, jreg, tau, eta, eta_g),
                  _make(TB, name, reg, tau, eta, eta_g))
    if name == "fast_fedda":
        talg = _replaying(talg)
    jeng = JRoundEngine(jalg, jgrad, 30, JEngineConfig(
        chunk_rounds=3, transport=jcomm.TopK(ratio=0.5)))
    teng = RoundEngine(talg, grad_fn, 30, EngineConfig(
        chunk_rounds=3, transport=comm.TopK(ratio=0.5)), device="cpu")
    dense = RoundEngine(talg, grad_fn, 30, EngineConfig(
        transport=comm.Dense()), device="cpu")
    js, _ = jeng.run(jeng.init(jp0), lambda r, rng: j_make_round_batches(
        jd, tau, 16, rng), 3, seed=0)
    ts, _ = teng.run(teng.init(p0), lambda r, rng: make_round_batches(
        data, tau, 16, rng), 3, seed=0)
    dense.run(dense.init(p0), lambda r, rng: make_round_batches(
        data, tau, 16, rng), 1, seed=0)
    assert dense.uplink_bytes_per_client_round == vectors * 21 * 8
    assert teng.uplink_bytes_per_client_round == \
        jeng.uplink_bytes_per_client_round
    _assert_state_close(ts, js)


def test_engine_refuses_participation_and_protocol_for_a_baseline():
    """The twin of tests/test_exec.py:372-378: the baselines take no
    active mask and have no protocol form."""
    (_, _, _, _), (data, reg, grad_fn, p0), (eta, eta_g) = _fig2(2)
    for name in NAMES:
        alg = _make(TB, name, reg, 2, eta, eta_g)
        with pytest.raises(ValueError, match="partial participation"):
            RoundEngine(alg, grad_fn, 30, EngineConfig(participation=0.5),
                        device="cpu")
        with pytest.raises(ValueError, match="protocol"):
            RoundEngine(alg, grad_fn, 30, EngineConfig(protocol=True),
                        device="cpu")


def test_tau1_dprox_coincides_with_fedda():
    """The twin of tests/test_algorithm.py:86: at tau = 1 DProx (through the
    fused kernel's entry, its plain version here) and FedDA (plain ops) give
    the same x_bar; no baseline reaches the kernel's entry."""
    (_, _, _, _), (data, reg, grad_fn, p0), (eta, eta_g) = _fig2(1)
    dprox = tsim.DProxAlgorithm(reg, DProxConfig(tau=1, eta=eta,
                                                 eta_g=eta_g))
    fedda = TB.FedDA(reg, 1, eta, eta_g)
    rf, rf_da = dprox.make_round_fn(grad_fn), fedda.make_round_fn(grad_fn)
    s, s_da = dprox.init(p0, 30), fedda.init(p0, 30)
    rng = np.random.default_rng(0)
    calls = []
    real = fused_prox._update_plain

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    fused_prox._update_plain = counting
    try:
        for _ in range(10):
            b = make_round_batches(data, 1, None, rng)
            s, _ = rf(s, b)
            n = len(calls)
            s_da, _ = rf_da(s_da, b)
            assert len(calls) == n
    finally:
        fused_prox._update_plain = real
    assert len(calls) == 10
    np.testing.assert_allclose(s.x_bar["w"].numpy(), s_da.x_bar["w"].numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("b", [1, 20])
@pytest.mark.parametrize("name", ["dprox", "fedda", "fast_fedda"])
def test_fig3_minibatch_runs_match_reference(name, b):
    """Fig. 3's set-up (``fig3_stochastic.py:19-39``): m 400, lam 0.0005,
    tau 20, eta_g 8, minibatches of b, 3 rounds through both simulators."""
    tau, eta_g = 20, 8.0
    jd, jreg, jgrad, jfull, jp0, L = j_logreg_problem(m=400, lam=0.0005)
    data, reg, grad_fn, full_g, p0, _ = problems.logreg_problem(
        m=400, lam=0.0005, device="cpu")
    eta_tilde = 0.5 / L
    eta = eta_tilde / (eta_g * tau)

    def algs(pkg, sim, r):
        if name == "dprox":
            cfg = (JConfig if pkg is JB else DProxConfig)(
                tau=tau, eta=eta, eta_g=eta_g)
            return sim.DProxAlgorithm(r, cfg)
        if name == "fedda":
            return pkg.FedDA(r, tau, eta, eta_g)
        alg = pkg.FastFedDA(r, tau, eta0=eta * eta_g, eta_g=eta_g)
        return _replaying(alg) if pkg is TB else alg

    h = jsim.run(algs(JB, jsim, jreg), jp0, jgrad,
                 lambda r, rng: j_make_round_batches(jd, tau, b, rng), 30, 3,
                 reg=jreg, eta_tilde=eta_tilde, full_grad_fn=jfull,
                 eval_every=1)
    t = tsim.run(algs(TB, tsim, reg), p0, grad_fn,
                 lambda r, rng: make_round_batches(data, tau, b, rng), 30, 3,
                 reg=reg, eta_tilde=eta_tilde, full_grad_fn=full_g,
                 eval_every=1, device="cpu")
    assert t.rounds == h.rounds
    for g, e in zip(t.optimality, h.optimality):
        assert (abs(g - e) <= 1e-6 * e) if e > 1e-9 else g <= 1e-9, (g, e)
    np.testing.assert_allclose(t.loss, h.loss, rtol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(t.extra["final_params"][k].numpy(),
                                   np.asarray(h.extra["final_params"][k]),
                                   rtol=RTOL, atol=ATOL)
