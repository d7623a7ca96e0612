"""The port's communication layer against the JAX reference
(repro_torch.comm vs repro.comm), plus torch twins of the compressor
contracts of tests/test_comm.py.  CPU only: the compressors' kernels run
their plain versions here (tests/test_torch_gpu.py holds the kernels to
them on the card).

Parity is BITWISE in float32 and float64: the same message goes through
both packages, TopK and Dense as they are, RandK and Quantize with the
reference's ``jax.random`` draws replayed through
:class:`repro_torch.comm.ReplayDraws`.  The twins of the statistical
contracts use the port's own ``torch.Generator`` draws, with the
reference's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import plane as jpln
from repro_torch import comm
from repro_torch.comm import GeneratorDraws, ReplayDraws
from repro_torch.core import plane as pln
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


def _msg_np(seed=0, n=3, d=40, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, d)).astype(dtype),
            "b": rng.normal(size=(n,)).astype(dtype),
            "m": rng.normal(size=(n, 5, 4)).astype(dtype)}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return tu.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view({4: np.uint32, 8: np.uint64, 2: np.uint16}[x.itemsize])


def _assert_tree_bitwise(got, exp):
    gl, el = tu.tree_leaves(got), jax.tree_util.tree_leaves(exp)
    assert len(gl) == len(el)
    for g, e in zip(gl, el):
        assert tuple(g.shape) == tuple(e.shape)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(e))


def _ref_draws(tr, msg, key):
    """The ``jax.random`` draws the reference's ``tr.apply(msg, key)``
    makes, in the order the port consumes them."""
    leaves = jax.tree_util.tree_leaves(msg)
    n = leaves[0].shape[0]
    if isinstance(tr, jcomm.Quantize):
        if tr.granularity == "global":
            spec = jpln.SegmentSpec.from_tree(msg, batch_dims=1)
            return [jax.random.uniform(key, (n, spec.d_pad),
                                       dtype=leaves[0].dtype)]
        keys = jax.random.split(key, len(leaves))
        return [jax.random.uniform(k, (n, int(np.prod(l.shape[1:]))),
                                   dtype=l.dtype)
                for l, k in zip(leaves, keys)]
    if isinstance(tr, jcomm.RandK):
        if tr.granularity == "global":
            d = jpln.SegmentSpec.from_tree(msg, batch_dims=1).d
            groups = [(d, key)]
        else:
            groups = [(int(np.prod(l.shape[1:])), k) for l, k in
                      zip(leaves, jax.random.split(key, len(leaves)))]
        out = []
        for d, k in groups:
            if jcomm.transport._k_of(tr.ratio, d) >= d:
                continue
            out += [jax.random.permutation(rk, d)
                    for rk in jax.random.split(k, n)]
        return out
    return []


PAIRS = {
    "dense": (lambda g: jcomm.Dense(), lambda g: comm.Dense()),
    "topk": (lambda g: jcomm.TopK(0.3, granularity=g),
             lambda g: comm.TopK(0.3, granularity=g)),
    "randk": (lambda g: jcomm.RandK(0.3, granularity=g),
              lambda g: comm.RandK(0.3, granularity=g)),
    "quantize": (lambda g: jcomm.Quantize(4, granularity=g),
                 lambda g: comm.Quantize(4, granularity=g)),
    "topk_sched": (
        lambda g: jcomm.ScheduledTopK(jcomm.RatioSchedule(0.3),
                                      granularity=g),
        lambda g: comm.ScheduledTopK(comm.RatioSchedule(0.3),
                                     granularity=g)),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
@pytest.mark.parametrize("gran", ["leaf", "global"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_compress_matches_reference_bitwise(name, gran, dtype):
    """Three rounds of error-feedback compression of the same messages:
    what the server receives and the residuals equal the reference's."""
    jtr, ttr = PAIRS[name][0](gran), PAIRS[name][1](gran)
    msgs = [_msg_np(seed=s, dtype=dtype) for s in range(3)]
    jstate = jtr.init_state(_j(msgs[0]))
    tstate = ttr.init_state(_t(msgs[0]))
    key = jax.random.PRNGKey(5)
    for m in msgs:
        key, sub = jax.random.split(key)
        jm = _j(m)
        jtarget = (jax.tree_util.tree_map(jnp.add, jstate, jm)
                   if jtr.error_feedback else jm)
        draws = ReplayDraws(_ref_draws(jtr, jtarget, sub))
        jhat, jstate = jtr.compress(jstate, jm, sub)
        that, tstate = ttr.compress(tstate, _t(m), draws)
        assert draws.remaining == 0
        _assert_tree_bitwise(that, jhat)
        _assert_tree_bitwise(tstate, jstate)
        assert tu.tree_leaves(that)[0].dtype == tu.tree_leaves(_t(m))[0].dtype


@pytest.mark.parametrize("gran", ["leaf", "global"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_compress_plane_matches_reference_bitwise(name, gran):
    """The flat-plane surface (``PlaneTransport``, one residual plane) equals
    the reference's, and at leaf granularity equals the per-leaf path."""
    jtr, ttr = PAIRS[name][0](gran), PAIRS[name][1](gran)
    m = _msg_np(seed=11)
    jspec = jpln.SegmentSpec.from_tree(_j(m), batch_dims=1)
    tspec = pln.SegmentSpec.from_tree(_t(m), batch_dims=1)
    assert (tspec.d, tspec.d_pad) == (jspec.d, jspec.d_pad)
    jpt, tpt = jcomm.PlaneTransport(jtr, jspec), comm.PlaneTransport(ttr,
                                                                     tspec)
    jflat, tflat = jpln.flatten(jspec, _j(m)), pln.flatten(tspec, _t(m))
    jst, tst = jpt.init_state(jflat), tpt.init_state(tflat)
    key = jax.random.PRNGKey(2)
    for _ in range(2):
        key, sub = jax.random.split(key)
        jtarget = jpln.unflatten(jspec, jflat + jst if jtr.error_feedback
                                 else jflat)
        draws = ReplayDraws(_ref_draws(jtr, jtarget, sub))
        jhat, jst = jpt.compress(jst, jflat, sub)
        that, tst2 = tpt.compress(tst, tflat, draws)
        np.testing.assert_array_equal(_bits(that.numpy()), _bits(jhat))
        if ttr.error_feedback:
            np.testing.assert_array_equal(_bits(tst2.numpy()), _bits(jst))
        if gran == "leaf" and not ttr.stochastic:
            # plane vs per-leaf: the same numbers, bitwise
            leaf_hat, _ = ttr.compress(
                pln.unflatten(tspec, tst) if ttr.error_feedback else (),
                pln.unflatten(tspec, tflat), None)
            assert torch.equal(pln.flatten(tspec, leaf_hat), that)
        tst = tst2


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
def test_uplink_and_downlink_bytes_match_reference(dtype):
    jspec = {"w": jax.ShapeDtypeStruct((30, 112_394), dtype),
             "b": jax.ShapeDtypeStruct((30,), dtype)}
    tspec = {"w": torch.empty((30, 112_394), dtype=torch.from_numpy(
        np.zeros(0, dtype)).dtype, device="meta"),
        "b": torch.empty((30,), dtype=torch.from_numpy(
            np.zeros(0, dtype)).dtype, device="meta")}
    server_j = {"x_bar": {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
                          for k, v in jspec.items()}}
    server_t = {"x_bar": {k: v[0] for k, v in tspec.items()}}
    for name, (jf, tf) in PAIRS.items():
        for g in ("leaf", "global"):
            jtr, ttr = jf(g), tf(g)
            assert ttr.uplink_bytes(tspec) == jtr.uplink_bytes(jspec), name
            assert (comm.DownlinkCompressor(ttr).downlink_bytes(server_t)
                    == jcomm.DownlinkCompressor(jtr).downlink_bytes(server_j))
    assert (comm.message_elements_per_client(tspec)
            == jcomm.message_elements_per_client(jspec) == 112_395)
    assert (comm.broadcast_elements(server_t)
            == jcomm.broadcast_elements(server_j) == 112_395)
    if dtype == np.float64:  # the wide compressed path's bytes
        assert comm.TopK(0.1, granularity="global").uplink_bytes(
            tspec) == 134_880
        assert comm.Quantize(8, granularity="global").uplink_bytes(
            tspec) == 126_453
        assert comm.Dense().uplink_bytes(tspec) == 899_160


def test_global_bytes_need_a_single_dtype_message():
    spec = {"w": torch.empty((2, 3), dtype=torch.float32, device="meta"),
            "b": torch.empty((2,), dtype=torch.float64, device="meta")}
    with pytest.raises(ValueError, match="single-dtype"):
        comm.TopK(0.5, granularity="global").uplink_bytes(spec)
    with pytest.raises(ValueError, match="granularity"):
        comm.TopK(0.5, granularity="tile")


@pytest.mark.parametrize("kind", ["constant", "linear", "bucketed"])
def test_schedule_keep_counts_and_bytes_match_reference(kind):
    ages = np.array([0, 1, 2, 3, 5, 9, 40], np.int32)
    js = jcomm.as_schedule(kind, ratio=0.3)
    ts = comm.as_schedule(kind, ratio=0.3)
    for d in (1, 7, 40, 112_395):
        np.testing.assert_array_equal(
            ts.keep_counts(torch.from_numpy(ages), d).numpy(),
            np.asarray(js.keep_counts(jnp.asarray(ages), d)))
    jspec = {"w": jax.ShapeDtypeStruct((7, 40), np.float64),
             "b": jax.ShapeDtypeStruct((7,), np.float64)}
    tspec = {"w": torch.empty((7, 40), dtype=torch.float64, device="meta"),
             "b": torch.empty((7,), dtype=torch.float64, device="meta")}
    for g in ("leaf", "global"):
        assert (comm.ScheduledTopK(ts, granularity=g).uplink_bytes(tspec)
                == jcomm.ScheduledTopK(js, granularity=g).uplink_bytes(jspec))


@pytest.mark.parametrize("gran", ["leaf", "global"])
def test_scheduled_topk_with_ages_matches_reference(gran):
    """The port has no age signal yet: every client is at age zero, which
    is the reference given all-zero ages (or none).  The linear and
    bucketed schedules round their age-0 count differently from the fixed
    TopK, so this is not the constant case again."""
    m = _msg_np(seed=4, n=5)
    zeros = jnp.zeros((5,), jnp.int32)
    for kw in ({"kind": "linear", "slope": 0.05, "floor": 0.1},
               {"kind": "bucketed", "buckets": (0.35, 0.2)}):
        js = jcomm.RatioSchedule(0.5, **kw)
        ts = comm.RatioSchedule(0.5, **kw)
        jt = jcomm.ScheduledTopK(js, granularity=gran)
        jhat, jst = jt.compress(jt.init_state(_j(m)), _j(m),
                                jax.random.PRNGKey(0), ages=zeros)
        tt = comm.ScheduledTopK(ts, granularity=gran)
        that, tst = tt.compress(tt.init_state(_t(m)), _t(m), None)
        _assert_tree_bitwise(that, jhat)
        _assert_tree_bitwise(tst, jst)


def test_constant_schedule_is_the_fixed_topk_bitwise():
    m = _t(_msg_np(seed=8))
    for g in ("leaf", "global"):
        fixed = comm.TopK(0.3, granularity=g).apply(m, None)
        sched = comm.ScheduledTopK(comm.RatioSchedule(0.3),
                                   granularity=g).apply(m, None)
        for a, b in zip(tu.tree_leaves(fixed), tu.tree_leaves(sched)):
            assert torch.equal(a, b)
    assert comm.scheduled_transport(comm.TopK(0.3)) is None
    st = comm.ScheduledTopK()
    assert comm.scheduled_transport(
        comm.PlaneTransport(st, pln.SegmentSpec.from_tree(
            m, batch_dims=1))) is st
    with pytest.raises(ValueError, match="kind"):
        comm.as_schedule("cubic")


# ---------------------------------------------------------------------------
# draw sources
# ---------------------------------------------------------------------------


def test_generator_draws_are_seeded_and_device_independent():
    a, b = GeneratorDraws(3), GeneratorDraws(3)
    u1, u2 = a.uniform((4, 5), torch.float64, "cpu"), b.uniform(
        (4, 5), torch.float64, "cpu")
    assert torch.equal(u1, u2) and u1.dtype == torch.float64
    assert float(u1.min()) >= 0.0 and float(u1.max()) < 1.0
    p = a.permutation(9, "cpu")
    assert sorted(p.tolist()) == list(range(9))
    assert not torch.equal(a.uniform((4, 5), torch.float64, "cpu"), u1)


def test_replay_draws_check_shapes_and_run_out():
    r = ReplayDraws([np.zeros((2, 3)), np.arange(4)])
    with pytest.raises(ValueError, match="shape"):
        r.uniform((3, 2), torch.float32, "cpu")
    r = ReplayDraws([np.zeros((2, 3)), np.arange(4)])
    assert r.uniform((2, 3), torch.float32, "cpu").dtype == torch.float32
    assert r.permutation(4, "cpu").dtype == torch.int64
    with pytest.raises(ValueError, match="exhausted"):
        r.permutation(4, "cpu")


# ---------------------------------------------------------------------------
# twins of tests/test_comm.py (the port's own draws)
# ---------------------------------------------------------------------------


def _tmsg(seed=0, n=3, d=40):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(n, d))),
            "b": torch.from_numpy(rng.normal(size=(n,)))}


@pytest.mark.parametrize("ratio", [0.05, 0.3, 0.62, 0.95])
def test_randk_unbiased_in_expectation_over_draws(ratio):
    tr = comm.RandK(ratio=ratio, error_feedback=False)
    msg = _tmsg()
    draws = GeneratorDraws(7)
    total = tu.tree_zeros_like(msg)
    n = 4096
    for _ in range(n):
        total = tu.tree_add(total, tr.apply(msg, draws))
    for k in msg:
        err = float(torch.max(torch.abs(total[k] / n - msg[k])))
        assert err < 0.35, (ratio, k, err)


@pytest.mark.parametrize("ratio", [0.05, 0.2, 0.5, 0.77, 1.0])
def test_topk_contraction_factor(ratio):
    tr = comm.TopK(ratio=ratio, error_feedback=False)
    msg = _tmsg(seed=3)
    x, cx = msg["w"].numpy(), tr.apply(msg, None)["w"].numpy()
    d = x.shape[1]
    k = max(1, min(d, int(round(ratio * d))))
    for row in range(x.shape[0]):
        lhs = np.sum((cx[row] - x[row]) ** 2)
        rhs = (1.0 - k / d) * np.sum(x[row] ** 2)
        assert lhs <= rhs + 1e-12, (ratio, row, lhs, rhs)


def test_topk_keeps_largest_magnitudes():
    x = {"v": torch.tensor([[1.0, -4.0, 0.5, 3.0]])}
    for g in ("leaf", "global"):
        out = comm.TopK(ratio=0.5, error_feedback=False,
                        granularity=g).apply(x, None)["v"]
        np.testing.assert_array_equal(out.numpy(), [[0.0, -4.0, 0.0, 3.0]])


@pytest.mark.parametrize("gran", ["leaf", "global"])
@pytest.mark.parametrize("bits", [2, 5, 8])
def test_quantize_unbiased_and_bounded(bits, gran):
    tr = comm.Quantize(bits=bits, error_feedback=False, granularity=gran)
    msg = {"w": _tmsg(seed=5)["w"]}
    draws = GeneratorDraws(11)
    outs = torch.stack([tr.apply(msg, draws)["w"] for _ in range(2048)])
    x = msg["w"].numpy()
    mean = outs.mean(dim=0).numpy()
    step = np.max(np.abs(x), axis=1, keepdims=True) / ((1 << bits) - 1)
    # stochastic rounding: unbiased, and every draw within one level
    assert np.max(np.abs(mean - x)) < 5 * float(np.max(step)) / np.sqrt(
        2048) * 10
    assert float(torch.max(torch.abs(outs - msg["w"][None]))) <= float(
        np.max(step)) + 1e-12


@pytest.mark.parametrize("tr", [
    comm.Dense(), comm.TopK(ratio=1.0), comm.RandK(ratio=1.0),
    comm.TopK(ratio=1.0, error_feedback=False),
    comm.TopK(ratio=1.0, granularity="global"),
], ids=["dense", "topk1", "randk1", "topk1_noef", "topk1_global"])
def test_ratio_one_transports_are_exact_identity(tr):
    msg = _tmsg(seed=9)
    state = tr.init_state(msg)
    out, state2 = tr.compress(state, msg, GeneratorDraws(0))
    for k in msg:
        assert torch.equal(out[k], msg[k])
    for leaf in tu.tree_leaves(state2):
        assert float(torch.max(torch.abs(leaf))) == 0.0


@pytest.mark.parametrize("tr", [
    comm.TopK(ratio=0.3), comm.RandK(ratio=0.3), comm.Quantize(bits=4),
    comm.TopK(ratio=0.3, granularity="global"),
    comm.Quantize(bits=4, granularity="global"),
], ids=["topk", "randk", "quantize", "topk_global", "quantize_global"])
def test_error_feedback_summation_identity(tr):
    """sum_t m_hat_t = sum_t m_t - e_T  (telescoping, exact in fp64)."""
    msgs = [_tmsg(seed=s) for s in range(6)]
    state = tr.init_state(msgs[0])
    sent = tu.tree_zeros_like(msgs[0])
    draws = GeneratorDraws(3)
    for m in msgs:
        m_hat, state = tr.compress(state, m, draws)
        sent = tu.tree_add(sent, m_hat)
    total = msgs[0]
    for m in msgs[1:]:
        total = tu.tree_add(total, m)
    for k in total:
        np.testing.assert_allclose((sent[k] + state[k]).numpy(),
                                   total[k].numpy(), rtol=1e-10, atol=1e-10)


def test_compressor_path_holds_in_float32():
    """No silent upcast in the compressor / error-feedback path."""
    msg = {k: v.float() for k, v in _tmsg().items()}
    for tr in (comm.Dense(), comm.TopK(ratio=0.3), comm.RandK(ratio=0.3),
               comm.Quantize(bits=4),
               comm.Quantize(bits=4, granularity="global")):
        state = tr.init_state(msg)
        draws = GeneratorDraws(1)
        for s in range(3):
            m_hat, state = tr.compress(
                state, {k: v + 0.01 * s for k, v in msg.items()}, draws)
            assert all(v.dtype == torch.float32 for v in m_hat.values())
            assert all(l.dtype == torch.float32
                       for l in tu.tree_leaves(state))


def test_get_transport_registry():
    assert isinstance(comm.get_transport("topk", ratio=0.2), comm.TopK)
    assert isinstance(comm.get_transport("dense"), comm.Dense)
    assert isinstance(comm.get_transport("topk_sched"), comm.ScheduledTopK)
    with pytest.raises(ValueError, match="unknown transport"):
        comm.get_transport("morse")
    assert [comm.get_transport(n).wire_encoding
            for n in ("dense", "topk", "randk", "quantize")] == [
        jcomm.get_transport(n).wire_encoding
        for n in ("dense", "topk", "randk", "quantize")]


def test_select_clients_advances_only_active_rows():
    m = _tmsg(seed=2, n=4)
    tr = comm.TopK(0.3)
    old = tr.init_state(m)
    _, new = tr.compress(old, m, None)
    mask = torch.tensor([True, False, True, False])
    got = tr.select_clients(mask, new, old)
    for k in m:
        assert torch.equal(got[k][mask], new[k][mask])
        assert torch.equal(got[k][~mask], old[k][~mask])
    spec = pln.SegmentSpec.from_tree(m, batch_dims=1)
    pt = comm.PlaneTransport(tr, spec)
    flat_new, flat_old = pln.flatten(spec, new), pln.flatten(spec, old)
    assert torch.equal(pln.flatten(spec, got),
                       pt.select_clients(mask, flat_new, flat_old))
    assert comm.Dense().select_clients(mask, (), ()) == ()


def test_downlink_identity_tracks_state_bitwise():
    """At ratio 1.0 the client-visible shadow equals the true server state
    bitwise (the subtractive seen-update form guarantees it)."""
    dl = comm.DownlinkCompressor(comm.TopK(ratio=1.0))
    rng = np.random.default_rng(0)
    fields = {"x_bar": {"w": torch.from_numpy(rng.normal(size=7))}}
    st = dl.init_state(fields)
    for s in range(4):
        fields = {"x_bar": {"w": fields["x_bar"]["w"] + 0.1 * s - 0.05}}
        visible, st = dl.broadcast(st, fields, None)
        assert torch.equal(visible["x_bar"]["w"], fields["x_bar"]["w"])


@pytest.mark.parametrize("gran", ["leaf", "global"])
def test_downlink_shadow_residual_telescopes(gran):
    """seen accumulates exactly what was broadcast, so one dense broadcast
    closes the gap completely."""
    dl = comm.DownlinkCompressor(comm.TopK(ratio=0.4, granularity=gran))
    rng = np.random.default_rng(1)
    fields = {"w": torch.from_numpy(rng.normal(size=10)),
              "b": torch.from_numpy(rng.normal(size=()))}
    st = dl.init_state(fields)
    for _ in range(6):
        fields = {k: v + torch.from_numpy(np.asarray(
            rng.normal(size=v.shape))) * 0.3 for k, v in fields.items()}
        visible, st = dl.broadcast(st, fields, None)
    visible, _ = comm.DownlinkCompressor(comm.Dense()).broadcast(
        st, fields, None)
    for k in fields:
        np.testing.assert_allclose(visible[k].numpy(), fields[k].numpy(),
                                   rtol=1e-12)


@pytest.mark.parametrize("name", ["topk", "quantize"])
def test_downlink_broadcast_matches_reference_bitwise(name):
    """The broadcast lifts the server state to one sender (n = 1 rows), so
    the per-client compressors serve it; global granularity included."""
    jtr, ttr = PAIRS[name][0]("global"), PAIRS[name][1]("global")
    rng = np.random.default_rng(4)
    f = {"x_bar": {"w": rng.normal(size=30), "b": rng.normal(size=())}}
    jdl, tdl = jcomm.DownlinkCompressor(jtr), comm.DownlinkCompressor(ttr)
    jst, tst = jdl.init_state(_j(f)), tdl.init_state(_t(f))
    key = jax.random.PRNGKey(9)
    for s in range(3):
        f = {"x_bar": {k: v + rng.normal(size=np.shape(v))
                       for k, v in f["x_bar"].items()}}
        key, sub = jax.random.split(key)
        innov = jax.tree_util.tree_map(lambda a, b: a[None] - b,
                                       _j(f), jst["seen"])
        draws = ReplayDraws(_ref_draws(jtr, innov, sub))
        jvis, jst = jdl.broadcast(jst, _j(f), sub)
        tvis, tst = tdl.broadcast(tst, _t(f), draws)
        _assert_tree_bitwise(tvis, jvis)
        _assert_tree_bitwise(tst, jst)
