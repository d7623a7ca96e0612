"""The port's compressed round engine against the JAX reference
(repro_torch.exec with ``transport=``/``downlink=``/``plane=`` vs
repro.exec), plus torch twins of the engine contracts of tests/test_comm.py
and tests/test_plane.py.  CPU only.

Tolerances:
  * the quickstart configuration (n 30, d 20, tau 10, global top-k 25% on
    the flat plane): optimality at rtol 1e-6 above 1e-9 (float32 norms, as
    in tests/test_torch_slice.py), and the kept coordinates of every
    client's uplink EQUAL round by round -- a selection that flips near the
    k-th magnitude would change the whole trajectory, so the sets are
    compared where a divergence would start;
  * the engines with per-leaf top-k, a top-k downlink and participation:
    state and residuals at rtol 1e-10 / 1e-9, the float32 loss at 1e-6;
  * the hand-driven Quantize(8, global) loop with the reference's draws
    replayed: state at rtol 1e-10, atol 1e-12 (the local steps differ from
    XLA's by FMA contraction and reduction order, see
    tests/test_torch_algorithm.py);
  * the port against itself (ratio one == bare engine, plane == leaf
    layout, chunking, step == run): bitwise.
"""
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import plane as jpln
from repro.core.algorithm import DProxConfig as JConfig
from repro.data.synthetic import make_round_batches as j_make_round_batches
from repro.exec import EngineConfig as JEngineConfig
from repro.exec import RoundEngine as JRoundEngine
from repro.fed import simulator as jsim
from repro.models import logreg as jlogreg
from repro_torch import comm, interop
from repro_torch.core import plane as pln
from repro_torch.core.algorithm import DProxConfig
from repro_torch.core.prox import L1
from repro_torch.data.synthetic import (logistic_heterogeneous,
                                        make_round_batches)
from repro_torch.exec import (ArraySupplier, EngineConfig, RoundEngine,
                              server_state_fields)
from repro_torch.fed import problems
from repro_torch.fed import simulator as tsim
from repro_torch.kernels import _build
from repro_torch.models import logreg
from repro_torch.utils import tree as tu


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


def _engine(alg, grad_fn, n, **cfg):
    return RoundEngine(alg, grad_fn, n, EngineConfig(**cfg), device="cpu")


def _run(engine, params0, supplier, rounds):
    return engine.run(engine.init(params0), supplier, rounds, seed=0)


def _sup(data, seed):
    return ArraySupplier.from_dataset(data, 3, 8, seed=seed)


def _assert_states_equal(a, b):
    for k in ("w", "b"):
        assert torch.equal(a.x_bar[k], b.x_bar[k])
        assert torch.equal(a.c[k], b.c[k])


def _assert_opt_close(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        if e > 1e-9:
            assert abs(g - e) <= 1e-6 * e, (g, e)
        else:
            assert g <= 1e-9, (g, e)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _RecordingTopK(comm.TopK):
    """TopK that keeps what each global compression sent."""

    sent: list = field(default_factory=list, compare=False, hash=False)

    def apply_flat(self, flat, draws, spec):
        out = super().apply_flat(flat, draws, spec)
        self.sent.append(out.clone())
        return out


def test_quickstart_global_topk_plane_matches_reference():
    """``examples/quickstart.py:137-143``: DProx with global top-k 25% on
    the flat plane, paper's Fig. 2 problem (n 30, m 100, d 20, tau 10)."""
    from benchmarks.common import logreg_problem as j_logreg_problem

    tau, rounds, every = 10, 200, 25
    data, reg, grad_fn, full_g, params0, L = j_logreg_problem()
    eta_g, eta_tilde = 15.0, 0.5 / L
    kw = dict(tau=tau, eta=eta_tilde / (eta_g * tau), eta_g=eta_g)
    jalg = jsim.DProxAlgorithm(reg, JConfig(**kw))
    jeng = JRoundEngine(jalg, grad_fn, 30, JEngineConfig(
        chunk_rounds=16, plane=True,
        transport=jcomm.TopK(ratio=0.25, granularity="global")))
    ref_sent = []
    jeng.set_uplink_sink(
        lambda r0, msgs, st: ref_sent.extend(np.asarray(msgs)))
    h = jsim.run(jalg, params0, grad_fn,
                 lambda r, rng: j_make_round_batches(data, tau, None, rng),
                 30, rounds, reg=reg, eta_tilde=eta_tilde,
                 full_grad_fn=full_g, eval_every=every, engine=jeng)

    td, treg, tgrad, tfull, tp0, tL = problems.logreg_problem(device="cpu")
    assert tL == L
    talg = tsim.DProxAlgorithm(treg, DProxConfig(**kw))
    rec = _RecordingTopK(ratio=0.25, granularity="global")
    teng = RoundEngine(talg, tgrad, 30, EngineConfig(
        chunk_rounds=16, plane=True, transport=rec), device="cpu")
    t = tsim.run(talg, tp0, tgrad,
                 lambda r, rng: make_round_batches(td, tau, None, rng),
                 30, rounds, reg=treg, eta_tilde=eta_tilde,
                 full_grad_fn=tfull, eval_every=every, engine=teng)

    assert len(rec.sent) == len(ref_sent) == rounds
    for r, (got, exp) in enumerate(zip(rec.sent, ref_sent)):
        assert got.shape == exp.shape == (30, 128)
        np.testing.assert_array_equal(got.numpy() != 0, exp != 0,
                                      err_msg=f"kept set differs, round {r}")
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-9, atol=1e-15)
    _assert_opt_close(t.optimality, h.optimality)
    # global top-k lets the bias ride the error feedback at d = 20, so the
    # run floors higher than the dense one (the quickstart's own comment)
    assert t.optimality[-1] < 0.05 * t.optimality[0]
    assert t.uplink_mbytes_per_round == h.uplink_mbytes_per_round
    assert teng.uplink_bytes_per_client_round == 5 * (8 + 4)


@pytest.mark.parametrize("plane", [False, True])
def test_quantize_global_loop_with_replayed_draws_matches_reference(plane):
    """Five hand-driven rounds -- local half, Quantize(8, global) with error
    feedback, server half -- in both packages, the reference's uniforms
    replayed into the port."""
    data, reg, grad_fn, params0 = _problem(seed=3)
    from repro.core import prox as jprox

    jalg = jsim.DProxAlgorithm(jprox.L1(lam=0.01),
                               JConfig(tau=3, eta=0.05, eta_g=2.0))
    talg = _dprox(reg)
    jlocal, jserver = (jalg.make_local_fn(jlogreg.make_grad_fn()),
                       jalg.make_server_fn())
    tlocal, tserver = talg.make_local_fn(grad_fn), talg.make_server_fn()
    jp0 = {"w": jnp.zeros(10, jnp.float64), "b": jnp.zeros((), jnp.float64)}
    jst, tst = jalg.init(jp0, 6), talg.init(params0, 6)
    jtr = jcomm.Quantize(8, granularity="global")
    ttr = comm.Quantize(8, granularity="global")
    jcs = tcs = None
    key = jax.random.PRNGKey(4)
    rng = np.random.default_rng(0)
    for r in range(5):
        b = j_make_round_batches(data, 3, 8, rng)
        jmsg, jaux = jlocal(jst, b)
        tmsg, taux = tlocal(tst, b)
        key, sub = jax.random.split(key)
        if plane:
            jspec = jpln.SegmentSpec.from_tree(jmsg, batch_dims=1)
            tspec = pln.SegmentSpec.from_tree(tmsg, batch_dims=1)
            jmsg, tmsg = jpln.flatten(jspec, jmsg), pln.flatten(tspec, tmsg)
            jtp, ttp = (jcomm.PlaneTransport(jtr, jspec),
                        comm.PlaneTransport(ttr, tspec))
        else:
            jtp, ttp = jtr, ttr
        if jcs is None:
            jcs, tcs = jtp.init_state(jmsg), ttp.init_state(tmsg)
        u = jax.random.uniform(sub, (6, 128), dtype=jnp.float64)
        draws = comm.ReplayDraws([u])
        jhat, jcs = jtp.compress(jcs, jmsg, sub)
        that, tcs = ttp.compress(tcs, tmsg, draws)
        assert draws.remaining == 0
        if plane:
            jhat, that = jpln.unflatten(jspec, jhat), pln.unflatten(tspec,
                                                                    that)
        jst, _ = jserver(jst, jhat, jaux)
        tst, _ = tserver(tst, that, taux)
        got = interop.state_to_numpy(tst)
        for k in ("w", "b"):
            np.testing.assert_allclose(got.x_bar[k], np.asarray(jst.x_bar[k]),
                                       rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(got.c[k], np.asarray(jst.c[k]),
                                       rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("tr", ["dense", "topk", "topk_global"])
def test_engine_bytes_and_uplink_spec_match_reference(tr):
    data, reg, grad_fn, params0 = _problem()
    jt, tt = {"dense": (jcomm.Dense(), comm.Dense()),
              "topk": (jcomm.TopK(0.5), comm.TopK(0.5)),
              "topk_global": (jcomm.TopK(0.5, granularity="global"),
                              comm.TopK(0.5, granularity="global"))}[tr]
    eng = _engine(_dprox(reg), grad_fn, 6, chunk_rounds=2, transport=tt,
                  downlink=tt)
    assert eng.uplink_bytes_per_client_round is None
    _run(eng, params0, _sup(data, 1), 2)
    expect = {"dense": 11 * 8, "topk": 5 * 12 + 1 * 12,
              "topk_global": 6 * 12}[tr]
    assert eng.uplink_bytes_per_client_round == expect
    fields = {"x_bar": {"w": jax.ShapeDtypeStruct((10,), np.float64),
                        "b": jax.ShapeDtypeStruct((), np.float64)}}
    assert (eng.downlink_bytes_per_client_round
            == jcomm.DownlinkCompressor(jt).downlink_bytes(fields))
    alg = _dprox(reg)
    state = alg.init(params0, 6)
    spec = comm.uplink_message_spec(alg, grad_fn, state,
                                    _sup(data, 1).sample_round(0, None))
    assert all(l.device.type == "meta" for l in tu.tree_leaves(spec))
    assert comm.message_elements_per_client(spec) == 11
    assert tt.uplink_bytes(spec) == expect


@pytest.mark.parametrize("plane", [False, True])
def test_compressed_leaf_topk_engine_matches_reference(plane):
    """Per-leaf top-k with error feedback and a top-k downlink, through
    both engines for 8 rounds (participation 0.5): the same trajectory."""
    data, reg, grad_fn, params0 = _problem(seed=5)
    from repro.core import prox as jprox
    from repro.exec import ArraySupplier as JArraySupplier

    kw = dict(chunk_rounds=4, plane=plane, participation=0.5)
    jalg = jsim.DProxAlgorithm(jprox.L1(lam=0.01),
                               JConfig(tau=3, eta=0.05, eta_g=2.0))
    jeng = JRoundEngine(jalg, jlogreg.make_grad_fn(), 6, JEngineConfig(
        transport=jcomm.TopK(0.5), downlink=jcomm.TopK(0.5), **kw))
    jp0 = {"w": jnp.zeros(10, jnp.float64), "b": jnp.zeros((), jnp.float64)}
    js, jm = jeng.run(jeng.init(jp0), JArraySupplier.from_dataset(
        data, 3, 8, seed=6), 8, seed=0)
    teng = _engine(_dprox(reg), grad_fn, 6, transport=comm.TopK(0.5),
                   downlink=comm.TopK(0.5), **kw)
    ts, tm = _run(teng, params0, _sup(data, 6), 8)
    got = interop.state_to_numpy(ts)
    for k in ("w", "b"):
        np.testing.assert_allclose(got.x_bar[k], np.asarray(js.x_bar[k]),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got.c[k], np.asarray(js.c[k]),
                                   rtol=1e-10, atol=1e-12)
    # the loss is a float32 mean in both packages
    np.testing.assert_allclose(tm["train_loss"], jm["train_loss"], rtol=1e-6)
    jcs = jeng._comm_state
    tcs = teng._comm_state
    if plane:
        np.testing.assert_allclose(tcs.numpy(), np.asarray(jcs), rtol=1e-9,
                                   atol=1e-12)
    else:
        for k in ("w", "b"):
            np.testing.assert_allclose(tcs[k].numpy(), np.asarray(jcs[k]),
                                       rtol=1e-9, atol=1e-12)


def test_simulator_reports_transport_megabytes():
    data, reg, grad_fn, params0 = _problem()
    alg = _dprox(reg)
    eng = _engine(alg, grad_fn, 6, chunk_rounds=2,
                  transport=comm.Quantize(8, granularity="global"))
    h = tsim.run(alg, params0, grad_fn, _sup(data, 2), 6, 4, engine=eng)
    # 11 coordinates * 9 bits -> 13 bytes + one float64 scale, 6 clients
    assert h.uplink_mbytes_per_round == (13 + 8) * 6 / 1e6
    h = tsim.run(alg, params0, grad_fn, _sup(data, 2), 6, 4, device="cpu")
    assert h.uplink_mbytes_per_round == 1 * 6 * 11 * 4 / 1e6


# ---------------------------------------------------------------------------
# twins of tests/test_comm.py and tests/test_plane.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", [False, True])
@pytest.mark.parametrize("tr", [None, comm.TopK(ratio=1.0),
                                comm.RandK(ratio=1.0),
                                comm.TopK(ratio=1.0, granularity="global")],
                         ids=["dense_default", "topk1", "randk1",
                              "topk1_global"])
def test_compressed_ratio_one_matches_bare_engine(tr, plane):
    data, reg, grad_fn, params0 = _problem(seed=1)
    sup = _sup(data, 2)
    alg = _dprox(reg)
    s_in, m_in = _run(_engine(alg, grad_fn, 6, chunk_rounds=3), params0,
                      sup, 7)
    cfg = dict(chunk_rounds=3, plane=plane)
    if tr is None:  # the split round with no compressor: a Dense downlink
        cfg["downlink"] = comm.Dense()
    else:
        cfg["transport"] = tr
    s_c, m_c = _run(_engine(alg, grad_fn, 6, **cfg), params0, sup, 7)
    _assert_states_equal(s_in, s_c)
    assert m_in == m_c


@pytest.mark.parametrize("tr", [comm.RandK(ratio=0.5),
                                comm.Quantize(4, granularity="global"),
                                comm.TopK(0.3, granularity="global")],
                         ids=["randk", "quantize_global", "topk_global"])
def test_compressed_trajectory_invariant_to_chunking(tr):
    """Compressor state and the draw stream persist across chunk boundaries:
    the trajectory does not depend on chunk_rounds, and run == step."""
    data, reg, grad_fn, params0 = _problem(seed=2)
    sup = _sup(data, 3)
    alg = _dprox(reg)
    states = []
    for ch in (1, 4):
        eng = _engine(alg, grad_fn, 6, chunk_rounds=ch, transport=tr,
                      downlink=comm.TopK(0.5), plane=True)
        states.append(_run(eng, params0, sup, 6)[0])
    _assert_states_equal(*states)
    eng = _engine(alg, grad_fn, 6, transport=tr, downlink=comm.TopK(0.5),
                  plane=True)
    s = eng.init(params0)
    for r in range(6):
        s, info = eng.step(s, sup.sample_round(r, None))
    _assert_states_equal(s, states[0])
    assert set(info) == {"train_loss", "drift"}


@pytest.mark.parametrize("tr", [comm.TopK(0.3), comm.Quantize(4),
                                comm.RandK(0.4),
                                comm.ScheduledTopK(comm.RatioSchedule(0.3))],
                         ids=["topk", "quantize", "randk", "topk_sched"])
def test_plane_layout_is_bitwise_the_leaf_layout(tr):
    """At leaf granularity the flat-plane carry equals the per-leaf carry
    bitwise (tests/test_plane.py's contract), draws included."""
    data, reg, grad_fn, params0 = _problem(seed=7)
    sup = _sup(data, 8)
    alg = _dprox(reg)
    out = []
    for plane in (False, True):
        eng = _engine(alg, grad_fn, 6, chunk_rounds=2, transport=tr,
                      plane=plane, comm_seed=5)
        s, m = _run(eng, params0, sup, 5)
        cs = eng._comm_state
        out.append((s, m, cs if plane else pln.flatten(
            pln.SegmentSpec.from_tree(cs, batch_dims=1), cs)))
    _assert_states_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    assert torch.equal(out[0][2], out[1][2])


def test_compressed_ratio_below_one_bounded_residual():
    """TopK(0.5) + error feedback stays within the reference's envelope of
    the dense trajectory while still training."""
    data, reg, grad_fn, params0 = _problem(seed=0)
    sup = _sup(data, 1)
    alg = _dprox(reg)
    s_in, _ = _run(_engine(alg, grad_fn, 6, chunk_rounds=4), params0, sup,
                   20)
    s_c, m_c = _run(_engine(alg, grad_fn, 6, chunk_rounds=4,
                            transport=comm.TopK(ratio=0.5)), params0, sup, 20)
    w_in, w_c = s_in.x_bar["w"].numpy(), s_c.x_bar["w"].numpy()
    rel = float(np.linalg.norm(w_c - w_in) / np.linalg.norm(w_in))
    assert 0.0 < rel < 0.55, rel
    losses = m_c["train_loss"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_compressed_supports_partial_participation():
    data, reg, grad_fn, params0 = _problem(seed=4)
    sup = _sup(data, 5)
    alg = _dprox(reg)
    s_in, _ = _run(_engine(alg, grad_fn, 6, chunk_rounds=2,
                           participation=1.0), params0, sup, 4)
    s_c, _ = _run(_engine(alg, grad_fn, 6, chunk_rounds=2, participation=1.0,
                          transport=comm.RandK(ratio=1.0)), params0, sup, 4)
    _assert_states_equal(s_in, s_c)
    state, metrics = _run(_engine(alg, grad_fn, 6, chunk_rounds=2,
                                  participation=0.5,
                                  transport=comm.TopK(ratio=0.5)),
                          params0, sup, 8)
    assert np.isfinite(metrics["train_loss"]).all()
    assert bool(tu.tree_isfinite(state.x_bar))


@pytest.mark.parametrize("plane", [False, True])
def test_inactive_clients_keep_error_feedback_residuals(plane):
    """Non-participants transmit nothing, so their error-feedback state does
    not advance."""
    data, reg, grad_fn, params0 = _problem(seed=6)
    sup = _sup(data, 7)
    eng = _engine(_dprox(reg), grad_fn, 6, participation=0.5, plane=plane,
                  transport=comm.TopK(ratio=0.3, granularity="global"))
    state = eng.init(params0)
    active = np.zeros(6, bool)
    active[:2] = True

    def resid():
        cs = eng._comm_state
        return (cs if plane else pln.flatten(
            pln.SegmentSpec.from_tree(cs, batch_dims=1), cs)).numpy()

    state, _ = eng.step(state, sup.sample_round(0, None), active=active)
    res = resid()
    assert np.abs(res[:2]).max() > 0
    np.testing.assert_array_equal(res[2:], 0.0)
    state, _ = eng.step(state, sup.sample_round(1, None), active=active)
    np.testing.assert_array_equal(resid()[2:], 0.0)
    with pytest.raises(ValueError, match="active mask"):
        eng.step(state, sup.sample_round(2, None))


def test_engine_downlink_ratio_one_matches_compressed():
    data, reg, grad_fn, params0 = _problem(seed=3)
    sup = _sup(data, 4)
    alg = _dprox(reg)
    s_c, m_c = _run(_engine(alg, grad_fn, 6, chunk_rounds=3,
                            transport=comm.Dense()), params0, sup, 7)
    s_d, m_d = _run(_engine(alg, grad_fn, 6, chunk_rounds=3,
                            downlink=comm.Dense()), params0, sup, 7)
    _assert_states_equal(s_c, s_d)
    assert m_c == m_d


def test_engine_downlink_topk_trains_and_reports_bytes():
    data, reg, grad_fn, params0 = _problem(seed=5)
    sup = _sup(data, 6)
    eng = _engine(_dprox(reg), grad_fn, 6, chunk_rounds=4,
                  transport=comm.TopK(ratio=0.5),
                  downlink=comm.TopK(ratio=0.5))
    state, metrics = _run(eng, params0, sup, 20)
    losses = metrics["train_loss"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert bool(tu.tree_isfinite(state.x_bar))
    assert eng.downlink_bytes_per_client_round == 6 * (8 + 4)
    assert eng.uplink_bytes_per_client_round == 6 * (8 + 4)
    seen = eng._dl_state["seen"]["x_bar"]
    assert seen["w"].shape == (1, 10)
    fields = server_state_fields(eng.algorithm, state)
    assert set(fields) == {"x_bar"}


def test_config_checks_and_stage_stack():
    data, reg, grad_fn, params0 = _problem()
    assert EngineConfig().resolve().names() == ()
    assert not EngineConfig(plane=True).resolve().split
    stack = EngineConfig(transport=comm.Dense()).resolve()
    assert stack.split and stack.names() == ("uplink",)
    stack = EngineConfig(downlink=comm.TopK(0.5)).resolve()
    assert stack.names() == ("uplink", "downlink")
    assert isinstance(stack.downlink.compressor, comm.DownlinkCompressor)
    assert isinstance(stack.uplink.resolve_transport(), comm.Dense)
    with pytest.raises(ValueError, match="Transport"):
        EngineConfig(transport=object()).validate()
    # the asynchrony, cohort and placement fields resolve to their stages
    # (placement needs the params' logical-axis specs)
    for f, v, stage in [("clock", "straggler", "asynchrony"),
                        ("buffer_size", 3, "asynchrony"),
                        ("cohort", 2, "cohort")]:
        assert stage in EngineConfig(**{f: v}).resolve().names()
    with pytest.raises(ValueError, match="param_specs"):
        EngineConfig(mesh=object()).resolve()
    assert EngineConfig(mesh=object(), param_specs={}).resolve().names() \
        == ("placement",)

    class NoSplit(tsim.DProxAlgorithm):
        def make_local_fn(self, grad_fn):
            raise NotImplementedError

    with pytest.raises(ValueError, match="local/server split"):
        _engine(NoSplit(reg, DProxConfig(tau=2, eta=0.05, eta_g=2.0)),
                grad_fn, 6, transport=comm.Dense())
    # plane=True without a communication stage changes nothing
    sup = _sup(data, 9)
    alg = _dprox(reg)
    a, _ = _run(_engine(alg, grad_fn, 6, plane=True), params0, sup, 3)
    b, _ = _run(_engine(alg, grad_fn, 6), params0, sup, 3)
    _assert_states_equal(a, b)


def test_cpu_rounds_launch_no_kernel():
    data, reg, grad_fn, params0 = _problem()
    before = (_build.COUNTS["threshold_selects"],
              _build.COUNTS["quantizes"])
    for tr in (comm.TopK(0.3, granularity="global"),
               comm.Quantize(8, granularity="global")):
        _run(_engine(_dprox(reg), grad_fn, 6, plane=True, transport=tr),
             params0, _sup(data, 1), 2)
    assert (_build.COUNTS["threshold_selects"],
            _build.COUNTS["quantizes"]) == before
