"""Federated LM training in the port against the JAX reference, on the CPU:
the heterogeneous token streams, the transformer's loss and gradients, one
DProx round, the round engine over the token streams, and the trainer's
command line (``python -m repro_torch.launch.train``).

Params come from the reference's ``init_model`` (float32) through
:mod:`repro_torch.interop`; tokens from numpy, and for the audio and
vision front ends (hubert, internvl2) the reference's
``specs._example`` batches (features, targets and mask; patches and
tokens), carried across bitwise.  Every arch of ``registry.PORTED`` (all
ten) takes the loss, gradient and DProx-round checks.  Attention takes the
reference's CPU formulations (``naive`` and ``blocked``).  Tolerances:

  * token streams: bitwise (the same numpy code);
  * the loss at rtol 1e-5 and every gradient leaf within
    ``1e-5 * max |leaf|`` of ``jax.value_and_grad`` (measured <= 1.5e-6:
    the two libraries sum in different orders);
  * one DProx round (tau 2, 2 clients, L1 1e-5, eta 1e-3, eta_g 2, as
    tests/test_arch_smoke.py:67 but in float32): every x_bar leaf within
    ``1e-6 * max |leaf|`` (measured <= 1.2e-7) and the corrections c
    within ``1e-3 * max |c|`` over the tree (measured <= 3.9e-4: c is the
    difference of the mean and a client's average gradient, which agree to
    ~1e-6 of their size but differ from each other by far less than it);
  * four engine rounds (chunk 2): train_loss at rtol 1e-5, x_bar within
    ``1e-5 * max |x_bar|``.

mamba2 needs a looser bound on two leaves, stated in :data:`LOOSE`: its
``A_log`` gradient (at most ~3e-4, against ~1e-2 for the other leaves) is
a sum of terms that cancel, and ``dt_bias`` starts at zero, so after a
round its x_bar is the update alone and carries that update's relative
error.  Every other leaf of every arch keeps the bounds above.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import algorithm as jalg
from repro.core.prox import L1 as JL1
from repro.data import synthetic as jsyn
from repro.exec import ArraySupplier as JArraySupplier
from repro.exec import EngineConfig as JEngineConfig
from repro.exec import RoundEngine as JRoundEngine
from repro.fed.simulator import DProxAlgorithm as JDProxAlgorithm
from repro.launch import specs as jspecs
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.core import algorithm as talg
from repro_torch.core.prox import L1
from repro_torch.data import synthetic
from repro_torch.exec import ArraySupplier, EngineConfig, RoundEngine
from repro_torch.fed.simulator import DProxAlgorithm
from repro_torch.kernels import fused_prox
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T
from repro_torch.utils import tree as tu

ARCHS = list(registry.PORTED)

#: per (arch, check): {leaf name: relative bound} replacing the check's own
#: bound on that leaf.  mamba2, measured with this file's inputs: A_log's
#: gradient 5.4e-5 of its max |leaf| (1.9-5.4e-5 over token seeds 0-2);
#: dt_bias's x_bar after one DProx round 1.19e-5 of its max |leaf|
LOOSE = {("mamba2_130m", "grads"): {"A_log": 1e-4},
         ("mamba2_130m", "x_bar"): {"dt_bias": 1e-4}}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lms():
    """arch -> (reference cfg, reference params, port cfg, port params),
    float32, smoke scale."""
    out = {}
    with jax.enable_x64(False):
        for arch in ARCHS:
            jcfg = jreg.get_smoke(arch).with_overrides(
                param_dtype=jnp.float32)
            jp, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
            cfg = registry.get_smoke(arch).with_overrides(
                param_dtype=torch.float32)
            out[arch] = (jcfg, jp, cfg, interop.params_to_torch(jp, "cpu"))
    return out


def _leaves(tree):
    """Leaves in the reference's order (sorted dict keys)."""
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
            for x in tu.tree_leaves(tu.canonical(tree))]


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_tree_close(got, exp, rel, loose=None):
    """Every leaf within ``rel * max |leaf|`` of the reference's, a leaf
    named in ``loose`` ({last key: bound}) within its own bound."""
    g, e = _leaves(got), _jleaves(exp)
    names = [getattr(path[-1], "key", None) for path, _ in
             jax.tree_util.tree_flatten_with_path(exp)[0]]
    assert len(g) == len(e) == len(names)
    for a, b, name in zip(g, e, names):
        assert a.shape == b.shape
        tol = (loose or {}).get(name, rel) * float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def _tree_gap(got, exp) -> float:
    g, e = _leaves(got), _jleaves(exp)
    return (max(float(np.abs(a - b).max()) for a, b in zip(g, e))
            / max(float(np.abs(b).max()) for b in e))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,seq,n_seqs,vocab,seed,skew", [
    (2, 16, 8, 64, 0, 4.0), (3, 33, 5, 512, 7, 4.0), (1, 8, 3, 17, 3, 0.5),
    (4, 128, 2, 100, 11, 8.0)])
def test_token_streams_are_the_references_bitwise(n, seq, n_seqs, vocab,
                                                  seed, skew):
    got = synthetic.token_stream_heterogeneous(n, seq, n_seqs, vocab, seed,
                                               skew)
    exp = jsyn.token_stream_heterogeneous(n, seq, n_seqs, vocab, seed, skew)
    assert got.dtype == exp.dtype == np.int32 and got.shape == exp.shape
    assert got.tobytes() == exp.tobytes()


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------


def _tokens(vocab, b=2, s=32, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _np_batch(cfg, shape=(2, 32), seed=0):
    """A numpy batch of ``shape`` = (*lead, b, s) for ``cfg``: token ids, or
    for a front end the reference's ``specs._example`` (features, targets
    and mask; patches and tokens) drawn over ``prod(lead) * b`` rows and
    split over the leading axes."""
    *lead, b, s = shape
    rng = np.random.default_rng(seed)
    if cfg.frontend is None:
        return {"tokens": rng.integers(0, cfg.vocab, shape, dtype=np.int32)}
    n = int(np.prod(lead, dtype=int)) * b
    with jax.enable_x64(False):
        ex = jspecs._example(cfg, n, s, False, rng)
    return {k: np.asarray(v).reshape(tuple(lead) + (b,) + v.shape[1:])
            for k, v in ex.items()}


def _both(batch):
    """(the reference's batch, the port's): the same numbers, bf16
    bitwise."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            interop.params_to_torch(batch, "cpu"))


@pytest.mark.parametrize("impl", ["naive", "blocked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(lms, arch, impl):
    jcfg, jp, cfg, tp = lms[arch]
    jcfg = jcfg.with_overrides(attn_impl=impl, attn_block_q=8)
    cfg = cfg.with_overrides(attn_impl=impl, attn_block_q=8)
    jbatch, batch = _both(_np_batch(jcfg))
    with jax.enable_x64(False):
        jl, jg = jax.value_and_grad(lambda p, b: JT.loss_fn(p, jcfg, b))(
            jp, jbatch)
    loss, grads = T.make_grad_fn(cfg)(tp, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(T.loss_fn(tp, cfg, batch)), float(jl),
                               rtol=1e-5)
    _assert_tree_close(grads, jg, 1e-5, LOOSE.get((arch, "grads")))


def test_training_fields_are_the_references():
    """``remat`` and ``aux_loss_coef`` carry the reference's defaults and
    overrides; ``remat`` changes no number (accepted, not honoured)."""
    for arch in ARCHS:
        for get in ("get", "get_smoke"):
            j, t = getattr(jreg, get)(arch), getattr(registry, get)(arch)
            assert (t.remat, t.aux_loss_coef) == (j.remat, j.aux_loss_coef)
    cfg = registry.get_smoke("stablelm_1_6b").with_overrides(
        param_dtype=torch.float32, n_layers=1)
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.as_tensor(_tokens(cfg.vocab))}
    a = T.make_grad_fn(cfg)(params, batch)
    b = T.make_grad_fn(cfg.with_overrides(remat=False))(params, batch)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(tu.tree_leaves(a[1]),
                                                 tu.tree_leaves(b[1])))


@pytest.mark.parametrize("frontend", ["audio", "vision"])
def test_front_end_losses_raise(lms, frontend):
    """A front end's loss raises on a batch of tokens alone, missing its
    features (audio) or patches (vision), in both packages."""
    arch, key = {"audio": ("hubert_xlarge", "features"),
                 "vision": ("internvl2_26b", "patches")}[frontend]
    jcfg, jp, cfg, tp = lms[arch]
    toks = _tokens(cfg.vocab, 1, 4)
    with pytest.raises(KeyError, match=key):
        T.loss_fn(tp, cfg, {"tokens": torch.as_tensor(toks)})
    with pytest.raises(KeyError, match=key), jax.enable_x64(False):
        JT.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks)})


def test_grads_of_a_client_batch_need_no_copy_before_the_fused_update(lms):
    """``vmap(grad)`` hands kernel 1 gradient leaves whose per-client part
    is contiguous on every ported arch: no copy is made before the fused
    update (``fused_local_update_2d.copies``)."""
    for arch in ARCHS:
        jcfg, _, cfg, tp = lms[arch]
        _, batch = _both(_np_batch(jcfg, (2, 2, 32)))
        _, grads = torch.func.vmap(T.make_grad_fn(cfg), in_dims=(None, 0))(
            tp, batch)
        z = tu.tree_broadcast_axis0(tp, 2)
        before = fused_prox.fused_local_update_2d.copies
        fused_prox.fused_local_update(z, grads, tu.tree_zeros_like(z), 1e-3,
                                      1e-8, batch_dims=1)
        assert fused_prox.fused_local_update_2d.copies == before, arch


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_one_dprox_round_matches_the_reference(lms, arch):
    jcfg, jp, cfg, tp = lms[arch]
    tau, n = 2, 2
    jbatch, batch = _both(_np_batch(jcfg, (n, tau, 4, 64), seed=1))
    with jax.enable_x64(False):
        jfn = jax.jit(jalg.make_round_fn(
            jalg.DProxConfig(tau=tau, eta=1e-3, eta_g=2.0), JL1(lam=1e-5),
            JT.make_grad_fn(jcfg)))
        jstate, jinfo = jfn(jalg.init_state(jp, n), jbatch)
    fn = talg.make_round_fn(talg.DProxConfig(tau=tau, eta=1e-3, eta_g=2.0),
                            L1(lam=1e-5), T.make_grad_fn(cfg))
    state, info = fn(talg.init_state(tp, n), batch)
    np.testing.assert_allclose(float(info["train_loss"]),
                               float(jinfo["train_loss"]), rtol=1e-5)
    _assert_tree_close(state.x_bar, jstate.x_bar, 1e-6,
                       LOOSE.get((arch, "x_bar")))
    assert _tree_gap(state.c, jstate.c) <= 1e-3


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "gemma2_9b"])
def test_engine_over_the_token_streams_matches_the_reference(lms, arch):
    """``RoundEngine`` + ``ArraySupplier`` over the heterogeneous streams,
    4 rounds in chunks of 2, against the reference's engine."""
    jcfg, jp, cfg, tp = lms[arch]
    tau, n, b, seq = 2, 2, 2, 32
    streams = synthetic.token_stream_heterogeneous(n, seq, 8, cfg.vocab, 0)
    with jax.enable_x64(False):
        jeng = JRoundEngine(
            JDProxAlgorithm(JL1(1e-6), jalg.DProxConfig(tau, 2e-2, 2.0)),
            JT.make_grad_fn(jcfg), n, JEngineConfig(chunk_rounds=2))
        jstate, jm = jeng.run(jeng.init(jp), JArraySupplier(
            {"tokens": streams}, tau, b, seed=0), 4,
            rng=np.random.default_rng(0))
    eng = RoundEngine(DProxAlgorithm(L1(1e-6), talg.DProxConfig(tau, 2e-2,
                                                                2.0)),
                      T.make_grad_fn(cfg), n, EngineConfig(chunk_rounds=2),
                      device="cpu")
    seen = []
    state, m = eng.run(eng.init(tp), ArraySupplier({"tokens": streams}, tau,
                                                   b, seed=0), 4,
                       rng=np.random.default_rng(0),
                       metrics_cb=lambda r, info: seen.append(r))
    assert seen == [0, 1, 2, 3]
    np.testing.assert_allclose(m["train_loss"], jm["train_loss"], rtol=1e-5)
    assert _tree_gap(state.x_bar, jstate.x_bar) <= 1e-5


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--rounds", "2", "--tau", "2", "--clients", "2",
       "--batch", "2", "--seq", "16", "--chunk", "2", "--log-every", "1"]


def test_cli_trains_and_its_checkpoint_restores(tmp_path, capsys):
    path = str(tmp_path / "ck.npz")
    state = TR.main(CLI + ["--ckpt", path])
    out = capsys.readouterr().out
    assert "arch=stablelm-smoke params=467,584 clients=2 tau=2 alg=dprox" \
        in out
    assert out.count("round ") == 2 and "done: final loss" in out
    assert f"checkpoint -> {path}" in out
    back = ckpt.restore(path, state, device="cpu")
    assert ckpt.metadata(path)["round"] == 2
    for a, b in zip(tu.tree_leaves(back), tu.tree_leaves(state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("extra,expect", [
    (["--transport", "topk", "--plane", "--granularity", "global"],
     "uplink: 0.37 MB/client/round (topk"),
    (["--async"], "async: clock=straggler buffer=2/2"),
    (["--population", "4", "--cohort", "2", "--transport", "topk"],
     "cohort: 2/4 clients resident"),
    (["--publish-snapshots"], "snapshots: 1 published"),
], ids=["topk-plane", "async", "cohort", "snapshots"])
def test_cli_engine_stages(capsys, extra, expect):
    TR.main(CLI + extra)
    out = capsys.readouterr().out
    assert expect in out and "done: final loss" in out


@pytest.mark.parametrize("alg", ["dprox", "fedda", "fedmid", "fedavg",
                                 "scaffold"])
def test_cli_algorithms(capsys, alg):
    TR.main(CLI + ["--algorithm", alg])
    out = capsys.readouterr().out
    assert f"alg={alg}" in out
    last = [line for line in out.splitlines() if line.startswith("done:")]
    assert len(last) == 1 and "nan" not in last[0]


def test_cli_trace_and_metrics(tmp_path, capsys):
    import json

    trace, jsonl = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    TR.main(CLI + ["--trace", trace, "--metrics-jsonl", jsonl])
    out = capsys.readouterr().out
    assert f"trace -> {trace}" in out and f"metrics -> {jsonl}" in out
    lines = [json.loads(x) for x in open(jsonl)]
    assert [x.get("round") for x in lines[:2]] == [0, 1]
    assert json.load(open(trace))["traceEvents"]


def test_cli_autotune_raises_and_default_device_is_the_card(monkeypatch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        TR.main(CLI + ["--autotune", "4"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.main([a for a in CLI if a not in ("--device", "cpu")])


def test_scale_100m_is_the_references():
    from repro.launch import train as jtrain

    for arch in ARCHS:
        j = jtrain.scale_config(jreg.get(arch), "100m")
        t = TR.scale_config(registry.get(arch), "100m")
        assert (t.name, t.n_layers, t.d_model, t.d_ff, t.vocab, t.remat) == (
            j.name, j.n_layers, j.d_model, j.d_ff, j.vocab, j.remat)
        for field in ("attn", "rglru", "ssm"):
            tf, jf = getattr(t, field), getattr(j, field)
            assert (tf is None) == (jf is None), (arch, field)
            if tf is None:
                continue
            ta, ja = dataclasses.asdict(tf), dataclasses.asdict(jf)
            assert {k: ta[k] for k in ta if k in ja} == {
                k: ja[k] for k in ta if k in ja}
