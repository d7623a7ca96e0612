"""The port's simulated asynchrony (repro_torch.sched + the engine's
Asynchrony stage) against the JAX reference (repro.sched), plus torch twins
of the contracts of tests/test_sched.py.  CPU only.

Tolerances:
  * clock durations from the reference's replayed normals: rtol 2.4e-7
    (one float32 ulp) -- ``torch.exp`` and XLA's float32 ``exp`` differ by
    an ulp on a few percent of inputs, and neither is correctly rounded;
  * staleness weights ``(1 + a) ** -alpha``: rtol 2.3e-16 (one float64
    ulp, ``torch.pow`` against XLA's ``pow``); uniform weights exactly;
  * arrival selection (``_earliest_k``), ties included: the same ids in the
    same order and the same threshold, exactly;
  * the quickstart's two async configurations (n 30, d 20, tau 10, 200
    commits): per commit the ledger (age histogram, mean and max age)
    EQUAL, the virtual clock at rtol 1e-6 (the ulp-off durations add up),
    the float32 loss at rtol 1e-6; the optimality at every eval point at
    rtol 1e-6 above 1e-9 and the state after every 25 commits at rtol
    1e-8 (the local steps differ from XLA's by FMA contraction and
    reduction order, tests/test_torch_algorithm.py); in (b) the kept
    coordinates of every uplink EQUAL commit by commit;
  * the commit's client-axis sum (plain version of the commit kernel)
    against the reference's ``jnp.sum`` inside a jit-compiled scan at 30
    clients: bitwise;
  * the port against itself (zero delay == bare engine, chunking, queue
    depth 1 == one slot, stale-correction telescoping): bitwise, or rtol
    1e-12 where a float64 identity is summed in another order.
"""
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro import sched as jsched
from repro.core.algorithm import DProxConfig as JConfig
from repro.data.synthetic import make_round_batches as j_make_round_batches
from repro.exec import EngineConfig as JEngineConfig
from repro.exec import RoundEngine as JRoundEngine
from repro.fed import simulator as jsim
from repro.models import logreg as jlogreg
from repro.sched.aggregator import _earliest_k as j_earliest_k
from repro_torch import comm, interop, sched
from repro_torch.core.algorithm import DProxConfig
from repro_torch.core.prox import L1
from repro_torch.data.synthetic import (logistic_heterogeneous,
                                        make_round_batches)
from repro_torch.exec import ArraySupplier, EngineConfig, RoundEngine
from repro_torch.fed import problems
from repro_torch.fed import simulator as tsim
from repro_torch.kernels import plane_ops
from repro_torch.models import logreg
from repro_torch.sched.aggregator import _earliest_k

F32_ULP = 2.4e-7


@pytest.fixture(autouse=True)
def _x64_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _problem(n=6, m=30, d=10, seed=0, lam=0.01):
    data = logistic_heterogeneous(n_clients=n, m_per_client=m, d=d, alpha=5,
                                  beta=5, seed=seed)
    s = np.linalg.norm(data.features.reshape(-1, d), axis=1).max()
    data.features = (data.features / s).astype(np.float64)
    data.labels = data.labels.astype(np.float64)
    params0 = {"w": torch.zeros(d, dtype=torch.float64),
               "b": torch.zeros((), dtype=torch.float64)}
    return data, L1(lam=lam), logreg.make_grad_fn(), params0


def _dprox(reg, tau=3, eta=0.05, eta_g=2.0):
    return tsim.DProxAlgorithm(reg, DProxConfig(tau=tau, eta=eta,
                                                eta_g=eta_g))


def _run(alg, grad_fn, n, params0, sup, rounds, **cfg):
    eng = RoundEngine(alg, grad_fn, n, EngineConfig(**cfg), device="cpu")
    state, metrics = eng.run(eng.init(params0), sup, rounds, seed=0)
    return eng, state, metrics


def _assert_states_equal(a, b):
    for k in ("w", "b"):
        assert torch.equal(a.x_bar[k], b.x_bar[k])
        assert torch.equal(a.c[k], b.c[k])


def _ref_clock_draws(clock, seed: int, commits: int, n: int, key=None):
    """The draws the reference's clock takes from its key stream (the key
    of ``seed``, or ``key``), commit by commit (``clock_key, ksub =
    split(clock_key)`` per commit)."""
    key = jax.random.PRNGKey(seed) if key is None else key
    normals, bern = [], []
    for _ in range(commits):
        key, ksub = jax.random.split(key)
        if isinstance(clock, jsched.StragglerClock):
            k_jit, k_mix = jax.random.split(ksub)
            normals.append(np.asarray(jax.random.normal(k_jit, (n,),
                                                        jnp.float32)))
            bern.append(np.asarray(jax.random.bernoulli(
                k_mix, clock.straggler_frac, (n,))))
        else:
            normals.append(np.asarray(jax.random.normal(ksub, (n,),
                                                        jnp.float32)))
    persistent = getattr(clock, "persistent", True)
    return interop.clock_draws(normals, None if persistent else bern)


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda m: m.DeterministicClock(),
    lambda m: m.DeterministicClock(per_client=(1.0, 2.0, 0.5, 3.0, 1.5,
                                               1.0)),
    lambda m: m.DeterministicClock(upload=0.25),
    lambda m: m.LogNormalClock(median=2.0, sigma=0.7),
    lambda m: m.StragglerClock(slowdown=4.0),
    lambda m: m.StragglerClock(slowdown=3.0, straggler_frac=0.4,
                               persistent=False),
], ids=["zero_delay", "per_client", "upload_const", "lognormal",
        "straggler", "straggler_transient"])
def test_clocks_replay_reference_draws(make):
    n, commits = 6, 12
    jclock, tclock = make(jsched), make(sched)
    draws = _ref_clock_draws(jclock, 3, commits, n)
    key = jax.random.PRNGKey(3)
    for r in range(commits):
        key, ksub = jax.random.split(key)
        jc, ju = jclock.split_durations(ksub, r, n)
        tc, tu_ = tclock.split_durations(
            draws if tclock.stochastic else None, r, n, "cpu")
        assert tc.dtype == tu_.dtype == torch.float32
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=F32_ULP,
                                   atol=0)
        np.testing.assert_array_equal(tu_.numpy(), np.asarray(ju))
    if tclock.stochastic:
        assert draws.remaining == 0
    assert sched.clock_is_stochastic(tclock) == jsched.clock_is_stochastic(
        jclock)


def test_clock_registry_and_validation():
    assert isinstance(sched.get_clock("straggler", slowdown=2.0),
                      sched.StragglerClock)
    with pytest.raises(ValueError, match="unknown clock"):
        sched.get_clock("sundial")
    with pytest.raises(ValueError, match="per_client"):
        sched.DeterministicClock(per_client=(1.0, 2.0)).durations(
            None, 0, 3, "cpu")
    # the straggler clock slows exactly the declared fraction
    d = sched.StragglerClock(slowdown=10.0, jitter=0.0).durations(
        comm.GeneratorDraws(0), 0, 8, "cpu")
    np.testing.assert_array_equal(d.numpy(), [10.0, 10.0] + [1.0] * 6)


# ---------------------------------------------------------------------------
# the aggregator's pieces against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("edges", [1, 3])
def test_earliest_k_ties_match_reference(edges):
    """Equal delivery times are the rule under a deterministic clock: the
    port's stable sort picks the reference's ids in its order."""
    rng = np.random.default_rng(0)
    for trial in range(40):
        n = 12
        t = rng.integers(0, 4, size=n).astype(np.float32)
        if trial % 4 == 0:
            t[:] = 1.0  # every client at the same instant
        for k in (1, 4, 7, 12):
            ji, jt = j_earliest_k(jnp.asarray(t), k, edges)
            ti, tt = _earliest_k(torch.from_numpy(t), k, edges)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            assert float(tt) == float(jt)


def test_staleness_weights_match_reference():
    ages = np.arange(0, 64, dtype=np.int32)
    for pol in ("uniform", jsched.Staleness("poly"),
                jsched.Staleness("poly", alpha=1.3)):
        jp = jsched.as_staleness(pol)
        tp = sched.as_staleness(pol if isinstance(pol, str) else
                                sched.Staleness(pol.weighting, pol.alpha))
        jw = np.asarray(jp.weights(jnp.asarray(ages)))
        tw = tp.weights(torch.from_numpy(ages)).numpy()
        assert tw.dtype == jw.dtype == np.float64
        np.testing.assert_allclose(tw, jw, rtol=2.3e-16, atol=0)
    with pytest.raises(ValueError, match="weighting"):
        sched.as_staleness(sched.Staleness("harmonic"))
    with pytest.raises(ValueError, match="staleness"):
        sched.as_staleness(3)


def test_commit_sum_is_bitwise_the_references_scan_at_30_clients():
    """The server half's weighted client-axis mean inside the reference's
    compiled scan adds the 30 clients in order -- the commit kernel's (and
    its plain version's) order -- so the two are bitwise equal."""
    rng = np.random.default_rng(1)
    steps, n, d = 6, 30, 128
    z = rng.standard_normal((steps, n, d)) * np.exp(
        rng.uniform(-20, 20, (steps, n, 1)))
    act = rng.random((steps, n)) < 0.5

    def body(c, xs):
        zz, a = xs
        w = a.astype(jnp.float32)
        denom = jnp.maximum(jnp.sum(w), 1.0)
        wb = w.reshape((-1, 1)).astype(zz.dtype)
        return c, jnp.sum(zz * wb, axis=0) / denom.astype(zz.dtype)

    _, ref = jax.jit(lambda z, a: jax.lax.scan(body, 0, (z, a)))(z, act)
    for s in range(steps):
        w = torch.from_numpy(act[s]).to(torch.float32)
        got = plane_ops.weighted_commit_plain(torch.from_numpy(z[s]), w)
        got = got / torch.clamp_min(torch.sum(w), 1.0).to(torch.float64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref[s]))


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("staleness", [None, "poly",
                                       sched.Staleness("poly", correct=True)],
                         ids=["uniform", "poly", "poly_correct"])
@pytest.mark.parametrize("plane", [False, True])
def test_zero_delay_full_buffer_is_bitwise_the_bare_engine(staleness, plane):
    data, reg, grad_fn, params0 = _problem(seed=2)
    sup = ArraySupplier.from_dataset(data, 3, 8, seed=4)
    alg = _dprox(reg)
    _, bare, mb = _run(alg, grad_fn, 6, params0, sup, 5, chunk_rounds=2)
    eng, st, ma = _run(alg, grad_fn, 6, params0, sup, 5, chunk_rounds=2,
                       clock=sched.DeterministicClock(), buffer_size=6,
                       staleness=staleness, plane=plane)
    _assert_states_equal(bare, st)
    assert ma["train_loss"] == mb["train_loss"]
    assert ma["drift"] == mb["drift"]
    assert ma["vtime"] == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert ma["staleness_max"] == [0.0] * 5
    np.testing.assert_array_equal(ma["report_age_hist"][-1],
                                  [6, 0, 0, 0, 0, 0, 0, 0])


@pytest.mark.parametrize("plane", [False, True])
def test_async_trajectory_invariant_to_chunking(plane):
    data, reg, grad_fn, params0 = _problem(seed=3)
    sup = ArraySupplier.from_dataset(data, 3, 8, seed=5)
    alg = _dprox(reg)
    kw = dict(clock=sched.StragglerClock(slowdown=3.0), buffer_size=3,
              staleness=sched.Staleness("poly", correct=True), plane=plane,
              transport=comm.TopK(0.4), clock_seed=7)
    _, a, ma = _run(alg, grad_fn, 6, params0, sup, 7, chunk_rounds=1, **kw)
    _, b, mb = _run(alg, grad_fn, 6, params0, sup, 7, chunk_rounds=4, **kw)
    _assert_states_equal(a, b)
    assert ma["vtime"] == mb["vtime"]
    assert ma["staleness_mean"] == mb["staleness_mean"]


@pytest.mark.parametrize("plane", [False, True])
def test_queue_depth_one_is_the_one_slot_trajectory(plane):
    data, reg, grad_fn, params0 = _problem(seed=4)
    sup = ArraySupplier.from_dataset(data, 3, 8, seed=6)
    alg = _dprox(reg)
    kw = dict(chunk_rounds=3, clock=sched.StragglerClock(slowdown=3.0),
              buffer_size=2, staleness=sched.Staleness("poly", correct=True),
              plane=plane, transport=comm.TopK(0.5))
    e1, a, ma = _run(alg, grad_fn, 6, params0, sup, 8, **kw)
    e2, b, mb = _run(alg, grad_fn, 6, params0, sup, 8, queue_depth=1, **kw)
    _assert_states_equal(a, b)
    for k in ("vtime", "staleness_mean", "staleness_max", "train_loss"):
        assert ma[k] == mb[k], k
    assert isinstance(e2._sched_state, sched.QueueState)
    assert torch.equal(e1._comm_state if plane else e1._comm_state["w"],
                       e2._comm_state if plane else e2._comm_state["w"])


def test_stale_correction_telescopes_exactly():
    """``K * (x_T - x_0)`` equals every produced innovation minus the
    in-flight reports minus the residuals: downweighted mass is deferred,
    never dropped."""
    n, k, d, steps = 4, 2, 5, 17
    rng = np.random.default_rng(0)
    batches = torch.from_numpy(rng.normal(size=(steps, n, d)))

    def local_fn(state, batch):
        msg = {"v": batch}
        aux = {"loss_sum": torch.zeros((n,), dtype=torch.float32),
               "round": state["round"].expand(n)}
        return msg, aux

    def server_fn(state, msg, aux):
        return {"x": state["x"] + torch.mean(msg["v"], dim=0),
                "round": state["round"] + 1}, {}

    step = sched.make_async_round(
        local_fn, server_fn, comm.Dense(),
        sched.DeterministicClock(per_client=(1.0, 1.0, 2.5, 4.0)), k, n,
        sched.Staleness("poly", alpha=1.0, correct=True))
    state = {"x": torch.zeros(d, dtype=torch.float64),
             "round": torch.zeros((), dtype=torch.int32)}
    st = sched.init_async_state(*local_fn(state, batches[0]), n,
                                with_resid=True)
    produced = np.zeros((n, d))
    cs = ()
    for t in range(steps):
        refresh = st.need_refresh.numpy()
        produced += refresh[:, None] * batches[t].numpy()
        state, st, cs, _, _ = step(state, st, cs, batches[t])
    inflight = (~st.need_refresh.numpy())[:, None] * st.pending_msg["v"].numpy()
    resid = st.resid["v"].numpy()
    np.testing.assert_allclose(k * state["x"].numpy(),
                               (produced - inflight - resid).sum(axis=0),
                               rtol=1e-12, atol=1e-12)
    assert np.abs(resid).max() > 0


# ---------------------------------------------------------------------------
# the quickstart's async configurations against the reference
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _JRecTopK(jcomm.TopK):
    """The reference's TopK, recording every uplink plane it compresses."""

    sent: list = field(default_factory=list, compare=False, hash=False)

    def apply_plane(self, flat, key, spec):
        out = super().apply_plane(flat, key, spec)
        jax.debug.callback(lambda x: self.sent.append(np.asarray(x)), out,
                           ordered=True)
        return out


@dataclass(frozen=True)
class _TRecTopK(comm.TopK):
    sent: list = field(default_factory=list, compare=False, hash=False)

    def apply_plane(self, flat, draws, spec):
        out = super().apply_plane(flat, draws, spec)
        self.sent.append(out.clone())
        return out


def _quickstart_async(b: bool):
    """Quickstart (a) ``examples/quickstart.py:100-104`` and (b)
    ``:191-198``: 200 commits, compared every 25."""
    from benchmarks.common import logreg_problem as j_logreg_problem

    tau, commits, every, n = 10, 200, 25, 30
    data, reg, grad_fn, full_g, params0, L = j_logreg_problem()
    eta_g, eta_tilde = 15.0, 0.5 / L
    kw = dict(tau=tau, eta=eta_tilde / (eta_g * tau), eta_g=eta_g)
    jalg = jsim.DProxAlgorithm(reg, JConfig(**kw))
    td, treg, tgrad, tfull, tp0, tL = problems.logreg_problem(device="cpu")
    talg = tsim.DProxAlgorithm(treg, DProxConfig(**kw))
    jkw = dict(chunk_rounds=16, clock=jsched.StragglerClock(slowdown=4.0),
               buffer_size=15,
               staleness=jsched.Staleness("poly", correct=True))
    tkw = dict(chunk_rounds=16, clock=sched.StragglerClock(slowdown=4.0),
               buffer_size=15,
               staleness=sched.Staleness("poly", correct=True))
    jrec = trec = None
    if b:
        jrec, trec = _JRecTopK(ratio=0.25), _TRecTopK(ratio=0.25)
        jkw.update(plane=True, transport=jrec,
                   downlink=jcomm.TopK(ratio=0.25), queue_depth=2)
        tkw.update(plane=True, transport=trec, downlink=comm.TopK(ratio=0.25),
                   queue_depth=2)
    jeng = JRoundEngine(jalg, grad_fn, n, JEngineConfig(**jkw))
    teng = RoundEngine(talg, tgrad, n, EngineConfig(**tkw), device="cpu",
                       clock_draws=_ref_clock_draws(jkw["clock"], 0, commits,
                                                    n))
    js, ts = jeng.init(params0), teng.init(tp0)
    jm, tm = {}, {}
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    for r0 in range(0, commits, every):
        js, m1 = jeng.run(js, lambda r, g: j_make_round_batches(
            data, tau, None, g), every, rng=jrng, start_round=r0)
        ts, m2 = teng.run(ts, lambda r, g: make_round_batches(
            td, tau, None, g), every, rng=trng, start_round=r0)
        for m, acc in ((m1, jm), (m2, tm)):
            for k, v in m.items():
                acc.setdefault(k, []).extend(v)
        got = interop.state_to_numpy(ts)
        for f in ("x_bar", "c"):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    getattr(got, f)[k], np.asarray(getattr(js, f)[k]),
                    rtol=1e-8, atol=1e-13, err_msg=f"{f}[{k}] at {r0}")
    # the ledger, commit by commit
    np.testing.assert_array_equal(np.stack(tm["report_age_hist"]),
                                  np.stack(jm["report_age_hist"]))
    for k in ("staleness_mean", "staleness_max"):
        assert tm[k] == jm[k], k
    np.testing.assert_allclose(tm["vtime"], jm["vtime"], rtol=1e-6)
    np.testing.assert_allclose(tm["train_loss"], jm["train_loss"], rtol=1e-6)
    jsd, tsd = jeng._sched_state, teng._sched_state
    for f in ("last_synced", "last_age"):
        np.testing.assert_array_equal(getattr(tsd, f).numpy(),
                                      np.asarray(getattr(jsd, f)))
    # optimality at every eval point
    x_j = jalg.global_params(js)
    x_t = talg.global_params(ts)
    from repro.core.metrics import prox_gradient_norm as j_pgn
    from repro_torch.core.metrics import prox_gradient_norm as t_pgn

    gj = float(j_pgn(reg, full_g, x_j, eta_tilde))
    gt = float(t_pgn(treg, tfull, x_t, eta_tilde))
    assert abs(gt - gj) <= 1e-6 * gj or gj <= 1e-9
    return jm, tm, jrec, trec, teng


def test_quickstart_async_a_matches_reference():
    jm, tm, _, _, teng = _quickstart_async(False)
    assert max(tm["staleness_max"]) > 0  # stragglers reported stale
    assert tm["vtime"][-1] < 200 * 4.0  # commits did not wait for them


def test_quickstart_async_plane_topk_queue_matches_reference():
    before = plane_ops.weighted_commit_2d.launches
    jm, tm, jrec, trec, teng = _quickstart_async(True)
    assert len(trec.sent) == len(jrec.sent) == 200
    for r, (got, exp) in enumerate(zip(trec.sent, jrec.sent)):
        assert got.shape == exp.shape == (30, 128)
        np.testing.assert_array_equal(got.numpy() != 0, exp != 0,
                                      err_msg=f"kept set differs, commit {r}")
    assert isinstance(teng._sched_state, sched.QueueState)
    assert plane_ops.weighted_commit_2d.launches == before  # CPU: no kernel


def test_port_continues_from_the_references_async_state():
    """Quickstart (b)'s stages at n 6: the reference runs 6 commits, its
    state, queue (report planes, residual, ledger), error feedback and
    downlink shadow cross over through repro_torch.interop, the clock key's
    draws are replayed, and both continue 6 commits to the same result."""
    from repro.core import prox as jprox
    from repro.exec import ArraySupplier as JArraySupplier

    data, reg, grad_fn, params0 = _problem(seed=8)
    jalg = jsim.DProxAlgorithm(jprox.L1(lam=0.01),
                               JConfig(tau=3, eta=0.05, eta_g=2.0))
    jeng = JRoundEngine(jalg, jlogreg.make_grad_fn(), 6, JEngineConfig(
        chunk_rounds=3, plane=True, transport=jcomm.TopK(0.5),
        downlink=jcomm.TopK(0.5), clock=jsched.StragglerClock(slowdown=3.0),
        buffer_size=3, staleness=jsched.Staleness("poly", correct=True),
        queue_depth=2))
    jp0 = {"w": jnp.zeros(10, jnp.float64), "b": jnp.zeros((), jnp.float64)}
    jsup = JArraySupplier.from_dataset(data, 3, 8, seed=2)
    js, _ = jeng.run(jeng.init(jp0), jsup, 6, seed=0)
    jsd = jeng._sched_state
    teng = RoundEngine(_dprox(reg), grad_fn, 6, EngineConfig(
        chunk_rounds=3, plane=True, transport=comm.TopK(0.5),
        downlink=comm.TopK(0.5), clock=sched.StragglerClock(slowdown=3.0),
        buffer_size=3, staleness=sched.Staleness("poly", correct=True),
        queue_depth=2), device="cpu", clock_draws=_ref_clock_draws(
            jsched.StragglerClock(), 0, 6, 6, key=jsd.clock_key))
    tsup = ArraySupplier.from_dataset(data, 3, 8, seed=2)
    ts = interop.state_to_torch(js, "cpu")
    teng._extras = teng._init_extras(ts, tsup.sample_round(6))
    teng._extras.update(
        sched=interop.async_state_to_torch(jsd, "cpu"),
        comm=interop.params_to_torch(jeng._comm_state, "cpu"),
        dl=interop.params_to_torch(jeng._dl_state, "cpu"))
    assert isinstance(teng._sched_state, sched.QueueState)
    js, jm = jeng.run(js, jsup, 6, seed=0, start_round=6)
    ts, tm = teng.run(ts, tsup, 6, seed=0, start_round=6)
    got = interop.state_to_numpy(ts)
    for k in ("w", "b"):
        np.testing.assert_allclose(got.x_bar[k], np.asarray(js.x_bar[k]),
                                   rtol=1e-10, atol=1e-13)
    for k in ("staleness_mean", "staleness_max"):
        assert tm[k] == jm[k], k
    back = interop.async_state_to_numpy(teng._sched_state)
    np.testing.assert_array_equal(back.slot_filled,
                                  np.asarray(jeng._sched_state.slot_filled))
    np.testing.assert_allclose(back.pending_msg,
                               np.asarray(jeng._sched_state.pending_msg),
                               rtol=1e-9, atol=1e-13)


# ---------------------------------------------------------------------------
# staleness-adaptive compression under the ledger's ages
# ---------------------------------------------------------------------------


def test_scheduled_topk_bytes_follow_the_ledger_ages():
    data, reg, grad_fn, params0 = _problem(seed=5)
    from repro.core import prox as jprox
    from repro.exec import ArraySupplier as JArraySupplier

    jsch = jcomm.RatioSchedule(0.5, kind="linear", slope=0.2, floor=0.1)
    tsch = comm.RatioSchedule(0.5, kind="linear", slope=0.2, floor=0.1)
    for plane in (False, True):
        jalg = jsim.DProxAlgorithm(jprox.L1(lam=0.01),
                                   JConfig(tau=3, eta=0.05, eta_g=2.0))
        jeng = JRoundEngine(jalg, jlogreg.make_grad_fn(), 6, JEngineConfig(chunk_rounds=3, plane=plane,
                             transport=jcomm.ScheduledTopK(jsch),
                             clock=jsched.StragglerClock(slowdown=3.0),
                             buffer_size=2))
        jp0 = {"w": jnp.zeros(10, jnp.float64),
               "b": jnp.zeros((), jnp.float64)}
        js, jm = jeng.run(jeng.init(jp0), JArraySupplier.from_dataset(
            data, 3, 8, seed=2), 9, seed=0)
        teng = RoundEngine(
            _dprox(reg), grad_fn, 6, EngineConfig(
                chunk_rounds=3, plane=plane,
                transport=comm.ScheduledTopK(tsch),
                clock=sched.StragglerClock(slowdown=3.0), buffer_size=2),
            device="cpu", clock_draws=_ref_clock_draws(
                jsched.StragglerClock(), 0, 9, 6))
        ts, tm = teng.run(teng.init(params0), ArraySupplier.from_dataset(
            data, 3, 8, seed=2), 9, seed=0)
        assert tm["uplink_bytes"] == jm["uplink_bytes"]
        assert max(tm["staleness_max"]) > 0
        assert min(tm["uplink_bytes"]) < max(tm["uplink_bytes"])
        got = interop.state_to_numpy(ts)
        for k in ("w", "b"):
            np.testing.assert_allclose(got.x_bar[k], np.asarray(js.x_bar[k]),
                                       rtol=1e-10, atol=1e-12)
    # the byte accounting itself, at given ages
    ages = np.array([0, 1, 2, 3, 5, 9], np.int32)
    msg = {"w": torch.zeros((6, 10), dtype=torch.float64),
           "b": torch.zeros((6,), dtype=torch.float64)}
    jmsg = {"w": jax.ShapeDtypeStruct((6, 10), jnp.float64),
            "b": jax.ShapeDtypeStruct((6,), jnp.float64)}
    for gran in ("leaf", "global"):
        t = comm.ScheduledTopK(tsch, granularity=gran)
        j = jcomm.ScheduledTopK(jsch, granularity=gran)
        np.testing.assert_array_equal(
            t.scheduled_bytes(msg, torch.from_numpy(ages)).numpy(),
            np.asarray(j.scheduled_bytes(jmsg, jnp.asarray(ages))))


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def test_async_config_activates_the_stage_and_validates_as_reference():
    for kw in (dict(clock="straggler"), dict(clock=sched.StragglerClock()),
               dict(buffer_size=4), dict(staleness="poly"),
               dict(queue_depth=2), dict(edges=2)):
        stack = EngineConfig(**kw).resolve()
        assert stack.asynchrony is not None and stack.uplink is not None
        assert stack.names() == ("uplink", "asynchrony")
    data, reg, grad_fn, params0 = _problem()
    jbad = [dict(clock="straggler", participation=0.5),
            dict(buffer_size=0), dict(queue_depth=0), dict(edges=0)]
    for kw in jbad:
        with pytest.raises(ValueError) as je:
            JEngineConfig(**kw).validate()
        with pytest.raises(ValueError) as te:
            EngineConfig(**kw).validate()
        assert str(te.value) == str(je.value)
    for kw, n in ((dict(buffer_size=7), 6), (dict(buffer_size=4, edges=5),
                                             6)):
        with pytest.raises(ValueError) as je:
            JEngineConfig(**kw).validate(n)
        with pytest.raises(ValueError) as te:
            EngineConfig(**kw).validate(n)
        assert str(te.value).split(":")[0] == str(je.value).split(":")[0]
    with pytest.raises(ValueError, match="buffer_size"):
        RoundEngine(_dprox(reg), grad_fn, 6, EngineConfig(buffer_size=7),
                    device="cpu")
    with pytest.raises(ValueError, match="unknown clock"):
        RoundEngine(_dprox(reg), grad_fn, 6, EngineConfig(clock="sundial"),
                    device="cpu")
    with pytest.raises(ValueError, match="ClockModel"):
        RoundEngine(_dprox(reg), grad_fn, 6, EngineConfig(clock=object()),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="placement"):
        EngineConfig(mesh=object()).resolve()
