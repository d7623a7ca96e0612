"""The port's serving path against the JAX reference: the transformer's
prefill, caches and decode steps, the serving engine's greedy and sampled
tokens, and the reference's bfloat16 params carried across bitwise.

Weights come from the reference's ``init_model`` through
:mod:`repro_torch.interop`; prompts from numpy.  Everything runs on the CPU
(``device="cpu"``), where attention takes the reference's formulations; the
card runs the same path through the flash kernel (``chip_smoke.py`` phases
11 and 16 hold it to this CPU path).

Tolerances: float32 logits within ``1e-4 * max|logit|`` of the reference's
(the two packages sum in different orders); caches within ``1e-5`` of
their largest entry.  Greedy tokens are held equal; so are sampled tokens
when the reference's Gumbel draws are replayed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro.serving import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.comm import ReplayDraws
from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine, SnapshotStore
from repro_torch.utils import tree as tu

ARCHS = ["gemma2_9b", "stablelm_1_6b", "phi3_medium_14b", "recurrentgemma_9b",
         "mamba2_130m"]


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
    float32."""
    out = {}
    for arch in ARCHS:
        jcfg = jreg.get_smoke(arch).with_overrides(param_dtype=jnp.float32)
        jp, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
        cfg = registry.get_smoke(arch).with_overrides(
            param_dtype=torch.float32)
        out[arch] = (jcfg, jp, cfg, interop.params_to_torch(jp, "cpu"))
    return out


def _prompts(vocab, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, s), dtype=np.int32)


def _assert_logits(got, exp):
    exp = np.asarray(exp, np.float32)
    tol = 1e-4 * float(np.abs(exp).max())
    np.testing.assert_allclose(got.float().numpy(), exp, atol=tol, rtol=0)


def test_bf16_params_cross_bitwise():
    """The reference's default (bfloat16) gemma2 params -> torch -> numpy,
    every leaf bitwise, the nested ``stack`` layout and shapes kept."""
    cfg = jreg.get_smoke("gemma2_9b")
    assert cfg.param_dtype == jnp.bfloat16
    jp, _ = JT.init_model(jax.random.PRNGKey(1), cfg)
    tp = interop.params_to_torch(jp, "cpu")
    assert tp["stack"]["b0"]["mixer"]["wq"].dtype == torch.bfloat16
    assert tp["stack"]["b0"]["norm1"].dtype == torch.float32
    back = interop.params_to_numpy(tp)
    jl, jdef = jax.tree_util.tree_flatten(jp)
    bl, bdef = jax.tree_util.tree_flatten(back)
    assert jdef == bdef
    for a, b in zip(jl, bl):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_decode_match_reference(lms, arch):
    """Prefill logits, every cache buffer (gemma2's local layers with an
    80-token prompt against window 64: the ring buffer rolls) and 8 decode
    steps against the reference."""
    jcfg, jp, cfg, tp = lms[arch]
    s, steps, max_len = 80, 8, 96
    toks = _prompts(cfg.vocab, 2, s + steps, seed=1)
    jprefill = jax.jit(JT.prefill, static_argnums=(1, 3))
    jdecode = jax.jit(JT.decode_step, static_argnums=(1,))
    jlog, jc, jcl = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :s])},
                             max_len)
    log, c, cl = T.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :s])},
                           max_len=max_len)
    _assert_logits(log, jlog)
    last, _, _ = T.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :s])},
                           max_len=max_len, last_only=True)
    torch.testing.assert_close(last[:, 0], log[:, -1], rtol=0, atol=1e-5)
    assert int(cl) == int(jcl) == s
    if arch == "gemma2_9b":
        assert c["stack"]["b0"]["k"].shape[2] == 64  # the local ring
    for a, b in zip(jax.tree_util.tree_leaves(jc), tu.tree_leaves(c)):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-5 * float(np.abs(a).max()))
    jcl = jnp.asarray(s, jnp.int32)
    cl = torch.tensor(s, dtype=torch.int32)
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        jlog, jc = jdecode(jp, jcfg, jc, jnp.asarray(tok), jcl)
        log, c = T.decode_step(tp, cfg, c, torch.from_numpy(tok), cl)
        _assert_logits(log, jlog)
        jcl, cl = jcl + 1, cl + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(lms, arch):
    """Greedy ``generate`` and ``serve`` tokens equal the reference's."""
    jcfg, jp, cfg, tp = lms[arch]
    p = _prompts(cfg.vocab)
    jeng = JEngine(jcfg, jp, max_len=48)
    eng = ServingEngine(cfg, tp, max_len=48, device="cpu")
    exp = jeng.generate(p, max_new_tokens=8)
    got = eng.generate(p, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, exp.tokens)
    np.testing.assert_allclose(got.logprobs, exp.logprobs, rtol=0,
                               atol=1e-4)
    reqs = [Request(id=i, prompt=_prompts(cfg.vocab, 1, 6 + 3 * i, i)[0],
                    max_new_tokens=(5, 9, 7)[i]) for i in range(3)]
    jres = jeng.serve(reqs, slots=2, segment=3)
    res = eng.serve(reqs, slots=2, segment=3)
    assert [r.id for r in res] == [r.id for r in jres] == [0, 1, 2]
    for a, b in zip(res, jres):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_sampled_tokens_with_the_reference_draws(lms):
    """temperature > 0: the reference's Gumbel draws replayed into the port
    (one for the first token, then one per decode step from the split key
    stream) give the reference's tokens."""
    jcfg, jp, cfg, tp = lms["stablelm_1_6b"]
    p = _prompts(cfg.vocab)
    n, temp, seed = 8, 0.8, 3
    exp = JEngine(jcfg, jp, max_len=48).generate(p, max_new_tokens=n,
                                                 temperature=temp, seed=seed)
    key = jax.random.PRNGKey(seed)
    shape = (p.shape[0], cfg.vocab)
    draws = [np.asarray(jax.random.gumbel(key, shape, jnp.float32))]
    for _ in range(n):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    replay = ReplayDraws(draws)
    got = ServingEngine(cfg, tp, max_len=48, device="cpu").generate(
        p, max_new_tokens=n, temperature=temp, draws=replay)
    assert replay.remaining == 0
    np.testing.assert_array_equal(got.tokens, exp.tokens)
    np.testing.assert_allclose(got.logprobs, exp.logprobs, rtol=0, atol=1e-4)


# -- twins of tests/test_serving.py::TestDecodeParity -------------------------
# (the reference's loop == scan pins have no twin: the port's ``generate`` is
# itself the per-token loop, so there is no second decode path to pin)


def test_decode_and_admission_write_caches_in_place(lms):
    """``decode_step`` writes the slot into the buffers it was given and
    returns them; a serve admission copies its prefill into the pooled
    cache's row without replacing a buffer."""
    from repro_torch.serving.engine import _splice_caches

    _, _, cfg, tp = lms["gemma2_9b"]
    toks = torch.from_numpy(_prompts(cfg.vocab, 2, 20, seed=4))
    _, caches, cl = T.prefill(tp, cfg, {"tokens": toks}, max_len=32)
    ptrs = [x.data_ptr() for x in tu.tree_leaves(caches)]
    before = [x.clone() for x in tu.tree_leaves(caches)]
    _, out = T.decode_step(tp, cfg, caches, toks[:, :1], cl)
    after = tu.tree_leaves(out)
    assert [x.data_ptr() for x in after] == ptrs
    assert any(not torch.equal(a, b) for a, b in zip(after, before))

    pool = T.init_cache(cfg, 3, 32, "cpu")
    ptrs = [x.data_ptr() for x in tu.tree_leaves(pool)]
    _, one, _ = T.prefill(tp, cfg, {"tokens": toks[:1]}, max_len=32)
    _splice_caches(pool, one, 1)
    assert [x.data_ptr() for x in tu.tree_leaves(pool)] == ptrs
    for d, s_ in zip(tu.tree_leaves(pool["stack"]),
                     tu.tree_leaves(one["stack"])):
        torch.testing.assert_close(d[:, 1], s_[:, 0], rtol=0, atol=0)
        assert not d[:, 0].any() and not d[:, 2].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_serve_matches_sequential(lms, arch):
    """temperature > 0: each request's tokens in continuous batching equal
    a sequential ``generate`` with that request's draw source (``seed +
    id``): per-slot sampling draws row by row from the request's own
    stream, in the same order."""
    _, _, cfg, tp = lms[arch]
    eng = ServingEngine(cfg, tp, max_len=64, device="cpu")
    reqs = [Request(id=i, prompt=_prompts(cfg.vocab, 1, 5 + 4 * i, 7 + i)[0],
                    max_new_tokens=(6, 4, 7)[i]) for i in range(3)]
    res = eng.serve(reqs, slots=2, segment=3, temperature=0.8, seed=5)
    for r in res:
        seq = eng.generate(reqs[r.id].prompt[None], temperature=0.8,
                           max_new_tokens=reqs[r.id].max_new_tokens,
                           seed=5 + r.id)
        np.testing.assert_array_equal(r.tokens, seq.tokens[0])
        np.testing.assert_allclose(r.logprobs, seq.logprobs[0], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_matches_sequential(lms, arch):
    """Batched-with-admission trajectories == sequential per-request greedy
    decode, mixed prompt/output lengths, fewer slots than requests (gemma2:
    prompts and decode cross the local window of 64)."""
    _, _, cfg, tp = lms[arch]
    eng = ServingEngine(cfg, tp, max_len=96, device="cpu")
    reqs = [Request(id=i, prompt=_prompts(cfg.vocab, 1, 6 + 14 * (i % 5),
                                          i)[0],
                    max_new_tokens=(5, 9, 7, 5, 12)[i]) for i in range(5)]
    results = eng.serve(reqs, slots=2, segment=3)
    assert [r.id for r in results] == [0, 1, 2, 3, 4]
    for r in results:
        seq = eng.generate(reqs[r.id].prompt[None, :],
                           max_new_tokens=reqs[r.id].max_new_tokens)
        np.testing.assert_array_equal(r.tokens, seq.tokens[0])
    assert eng.metrics.counter("serve/requests").value == 5
    assert eng.metrics.counter("serve/tokens").value >= 38


def test_hot_swap_between_segments(lms):
    """A snapshot published mid-serve is adopted at a segment boundary:
    later admissions record the newer version, and the served tokens come
    from the new params."""
    _, _, cfg, tp = lms["stablelm_1_6b"]
    store = SnapshotStore()
    store.publish(tp, round=0)
    eng = ServingEngine(cfg, params=None, snapshots=store, max_len=64,
                        device="cpu")
    assert eng.refresh() is tp and eng.snapshot_version == 1

    bumped = tu.tree_map(lambda a: a * 1.01, tp)
    store.publish(bumped, round=1)
    p = _prompts(cfg.vocab)
    r = eng.generate(p, max_new_tokens=4)
    assert eng.snapshot_version == 2
    assert r.tokens.shape == (2, 4)
    eng2 = ServingEngine(cfg, bumped, max_len=64, device="cpu")
    np.testing.assert_array_equal(
        r.tokens, eng2.generate(p, max_new_tokens=4).tokens)

    # mid-serve: the store bumps after the first segment's admissions
    reqs = [Request(id=i, prompt=p[0], max_new_tokens=4) for i in range(3)]
    store.publish(tp, round=2)
    seen = []
    orig = eng._segment

    def segment(*a, **k):
        out = orig(*a, **k)
        if not seen:
            store.publish(bumped, round=3)
        seen.append(eng.snapshot_version)
        return out

    eng._segment = segment
    res = eng.serve(reqs, slots=2, segment=4)
    assert [r.snapshot_version for r in res] == [3, 3, 4]
