"""The rest of the model zoo in the port against the JAX reference, on the
CPU: the MoE block (grok-1, deepseek-v3), MLA attention (deepseek-v3), the
audio and vision front ends (hubert, internvl2), ``launch/specs``, the
attention's plain versions at the new head dims (hubert's 80, MLA's Dk 192
against Dv 128) with the wrapper's pad to the kernel's width, and the
serving engine's ``extra_inputs``.

Params come from the reference's ``init_*`` (float32) through
:mod:`repro_torch.interop`; inputs from numpy seeds or the reference's
``specs``.  Tolerances: float32 outputs within ``1e-5 * max |out|`` of the
reference's (the two libraries sum in different orders), scalars (the MoE
aux loss, losses) at rtol 1e-5, gradients within ``1e-5 * max |leaf|``;
logits of the whole model within ``1e-4 * max |logit|`` and caches within
``1e-5`` of their largest entry, as ``test_torch_serving.py``; ``specs``
bitwise; greedy tokens equal.  The one-DProx-round and loss/gradient
checks of the four archs are ``test_torch_train.py``'s (parametrised over
``registry.PORTED``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.kernels import ops as jops
from repro.launch import specs as jspecs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import base, registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import specs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine
from repro_torch.utils import tree as tu

NEW = ["hubert_xlarge", "internvl2_26b", "grok_1_314b", "deepseek_v3_671b"]


@pytest.fixture(autouse=True)
def _env():
    """One CPU thread (vmap of grad is far slower with more) and JAX in
    32-bit, whatever an earlier test module set."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.enable_x64(False):
            yield
    finally:
        torch.set_num_threads(threads)


def _t(x):
    """A reference array (or numpy array) as a CPU tensor, bf16 bitwise."""
    return interop.params_to_torch(x, "cpu")


def _np(t):
    return interop.params_to_numpy(t)


def _close(got, exp, rel=1e-5):
    exp = np.asarray(exp, np.float32)
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=0,
                               atol=rel * float(np.abs(exp).max()))


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _leaves(tree):
    """Leaves in the reference's order (sorted dict keys)."""
    return [x.detach() for x in tu.tree_leaves(tu.canonical(tree))]


@pytest.fixture(scope="module")
def smokes():
    """arch -> (reference cfg, reference params, port cfg, port params),
    float32, smoke scale, for the four archs of this slice."""
    out = {}
    with jax.enable_x64(False):
        for arch in NEW:
            jcfg = jreg.get_smoke(arch).with_overrides(
                param_dtype=jnp.float32)
            jp, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
            cfg = registry.get_smoke(arch).with_overrides(
                param_dtype=torch.float32)
            out[arch] = (jcfg, jp, cfg, interop.params_to_torch(jp, "cpu"))
    return out


def _lossless(cfg, moe_cls):
    """``cfg`` with a capacity no (token, k) pair overflows (E/K + 0.1, as
    tests/test_arch_smoke.py)."""
    m = cfg.moe
    return cfg.with_overrides(moe=moe_cls(**dict(
        dataclasses.asdict(m), capacity_factor=m.num_experts / m.top_k + 0.1)))


# ---------------------------------------------------------------------------
# registry, configs and the layer stack's layout
# ---------------------------------------------------------------------------


def test_all_ten_archs_are_ported_with_the_references_citation():
    assert registry.PORTED == registry.ARCH_IDS == jreg.ARCH_IDS
    for arch in registry.ARCH_IDS:
        for get in ("get", "get_smoke"):
            t, j = getattr(registry, get)(arch), getattr(jreg, get)(arch)
            assert (t.name, t.family, t.citation) == (j.name, j.family,
                                                      j.citation)
        assert registry.get(arch.replace("_", "-")) is registry.get(arch)


def _fields(cfg):
    """The config's fields that both packages carry, sub-configs as dicts."""
    skip = {"param_dtype", "fed_plan", "scan_unroll"}
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                     else v)
            for f in dataclasses.fields(cfg) if f.name not in skip
            for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("get", ["get", "get_smoke"])
@pytest.mark.parametrize("arch", NEW)
def test_configs_are_the_references(arch, get):
    t, j = getattr(registry, get)(arch), getattr(jreg, get)(arch)
    assert _fields(t) == _fields(j)
    assert t.param_dtype == torch.bfloat16 and j.param_dtype == jnp.bfloat16


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_params_and_caches_have_the_references_layout(arch):
    """init_model's tree (key paths and shapes) and init_cache's are the
    reference's, for every smoke arch: deepseek's dense prefix layer, the
    MoE and MLA leaves and the front-end projector included."""
    jcfg = jreg.get_smoke(arch).with_overrides(param_dtype=jnp.float32)
    cfg = registry.get_smoke(arch).with_overrides(param_dtype=torch.float32)
    assert T._block_sequence(cfg) == JT._block_sequence(jcfg)
    jp = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                              jcfg)[0])
    tp = T.init_model(torch.Generator().manual_seed(0), cfg)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = tu.tree_leaves(tu.canonical(tp))
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for _, x in flat]
    assert T.count_params(tp) == sum(int(np.prod(x.shape)) for _, x in flat)
    if cfg.decode_supported:
        jc = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 24)[0])
        tc = T.init_cache(cfg, 2, 24, "cpu")
        assert ([tuple(x.shape) for x in tu.tree_leaves(tu.canonical(tc))]
                == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jc)])


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_active_param_fraction_is_the_references(arch):
    for get in ("get", "get_smoke"):
        assert T.active_param_fraction(getattr(registry, get)(arch)) == \
            JT.active_param_fraction(getattr(jreg, get)(arch))


# ---------------------------------------------------------------------------
# launch/specs
# ---------------------------------------------------------------------------


def _same_bits(got: torch.Tensor, exp) -> bool:
    exp = np.asarray(exp)
    got = _np(got)
    return (got.dtype == exp.dtype and got.shape == exp.shape
            and got.tobytes() == exp.tobytes())


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_specs_example_is_the_references_bitwise(arch, seed):
    cfg, jcfg = registry.get_smoke(arch), jreg.get_smoke(arch)
    got = specs.example(cfg, 3, 40, seed, device="cpu")
    exp = jspecs._example(jcfg, 3, 40, False, np.random.default_rng(seed))
    assert sorted(got) == sorted(exp)
    for k in exp:
        assert _same_bits(got[k], exp[k]), k


@pytest.mark.parametrize("arch", NEW)
def test_specs_batches_and_decode_inputs_are_the_references(arch):
    cfg, jcfg = registry.get(arch), jreg.get(arch)
    shape = base.InputShape("t", "train", 24, 8)
    got = specs.train_batches(cfg, shape, 2, 3, seed=4, device="cpu")
    exp = jspecs.train_batches(jcfg, JSHAPES["train_4k"].__class__(
        "t", "train", 24, 8), 2, 3, abstract=False, seed=4)
    for k in exp:
        assert got[k].shape == (2, 3, 4) + tuple(exp[k].shape[3:])
        assert _same_bits(got[k].contiguous(), exp[k]), k
    pshape = base.InputShape("p", "prefill", 16, 2)
    got = specs.prefill_batch(cfg, pshape, seed=2, device="cpu")
    exp = jspecs.prefill_batch(jcfg, JSHAPES["prefill_32k"].__class__(
        "p", "prefill", 16, 2), abstract=False, seed=2)
    assert all(_same_bits(got[k], exp[k]) for k in exp)
    if not cfg.decode_supported:
        return
    smoke, jsmoke = registry.get_smoke(arch), jreg.get_smoke(arch)
    dshape = base.InputShape("d", "decode", 20, 3)
    lcfg, caches, tok, cl = specs.decode_inputs(smoke, dshape, seed=1,
                                                device="cpu")
    jl, jc, jtok, jcl = jspecs.decode_inputs(jsmoke, JSHAPES[
        "decode_32k"].__class__("d", "decode", 20, 3), abstract=False,
        seed=1)
    assert lcfg.name == jl.name
    assert _same_bits(tok, jtok) and int(cl) == int(jcl) == 19
    assert [tuple(x.shape) for x in tu.tree_leaves(tu.canonical(caches))] \
        == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jc)]


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

MOE_D, MOE_B, MOE_S = 32, 2, 24


def _moe_case(act, num_shared, cf, seed=0):
    jm = JL.MoECfg(num_experts=4, top_k=2, d_ff_expert=48,
                   num_shared=num_shared, d_ff_shared=40, capacity_factor=cf)
    tm = L.MoECfg(**dataclasses.asdict(jm))
    jp, _ = JL.init_moe(jax.random.PRNGKey(seed), jm, MOE_D, jnp.float32, act)
    # tokens that share a direction, as a sequence's do: the router favours
    # some experts, so a capacity of 1.25 drops pairs
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(MOE_B, MOE_S, MOE_D))
         + rng.normal(size=(MOE_D,))).astype(np.float32)
    return jm, tm, jp, interop.params_to_torch(jp, "cpu"), x


def _dropped(tm, tp, x) -> int:
    """(token, k) pairs past their expert's capacity."""
    xf = torch.as_tensor(x).reshape(-1, MOE_D)
    _, _, idx = L.moe_route(tp, tm, xf)
    counts = torch.bincount(idx.reshape(-1), minlength=tm.num_experts)
    return int(torch.clamp(counts - L.moe_capacity(tm, xf.shape[0]),
                           min=0).sum())


@pytest.mark.parametrize("num_shared", [0, 1])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("capacity", ["dropping", "lossless"])
def test_moe_matches_the_reference(capacity, act, num_shared):
    cf = 1.25 if capacity == "dropping" else 4 / 2 + 0.1
    jm, tm, jp, tp, x = _moe_case(act, num_shared, cf)
    assert L.moe_capacity(tm, MOE_B * MOE_S) == max(
        int(MOE_B * MOE_S * 2 / 4 * cf), 1)
    dropped = _dropped(tm, tp, x)
    assert (dropped > 0) == (capacity == "dropping")
    jout, jaux = JL.moe(jp, jm, jnp.asarray(x), act)
    out, aux = L.moe(tp, tm, torch.as_tensor(x), act)
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_moe_drops_past_capacity_in_token_order():
    """A (token, k) pair past its expert's capacity adds nothing: the
    dropping capacity's output equals the lossless one's on every token
    whose pairs all fit, and differs on the others."""
    jm, tm, jp, tp, x = _moe_case("gelu", 0, 1.25)
    lossless = dataclasses.replace(tm, capacity_factor=2.1)
    xt = torch.as_tensor(x)
    out, _ = L.moe(tp, tm, xt)
    ref, _ = L.moe(tp, lossless, xt)
    _, _, idx = L.moe_route(tp, tm, xt.reshape(-1, MOE_D))
    C = L.moe_capacity(tm, MOE_B * MOE_S)
    seen = torch.zeros(tm.num_experts, dtype=torch.long)
    fits = []
    for row in idx.tolist():
        ok = True
        for e in row:
            ok &= bool(seen[e] < C)
            seen[e] += 1
        fits.append(ok)
    fits = torch.tensor(fits)
    assert not fits.all()
    out, ref = out.reshape(-1, MOE_D), ref.reshape(-1, MOE_D)
    assert torch.equal(out[fits], ref[fits])
    assert (out[~fits] != ref[~fits]).any(-1).all()


@pytest.mark.parametrize("num_shared", [0, 1])
def test_vmapped_moe_gradients_match_jax_value_and_grad(num_shared):
    """``vmap(grad_and_value)`` over two clients (the trainer's pattern)
    through the dispatch's ``index_put`` and the ordered combine, against
    ``jax.value_and_grad`` per client, at the dropping capacity."""
    jm, tm, jp, tp, _ = _moe_case("swiglu", num_shared, 1.25, seed=1)
    xs = np.random.default_rng(7).normal(
        size=(2, MOE_B, MOE_S, MOE_D)).astype(np.float32)
    w = np.random.default_rng(8).normal(size=(MOE_D,)).astype(np.float32)

    def jloss(p, x):
        out, aux = JL.moe(p, jm, x)
        return jnp.sum(out * w) / out.size + 0.01 * aux

    def loss(p, x):
        out, aux = L.moe(p, tm, x)
        return torch.sum(out * torch.as_tensor(w)) / out.numel() + 0.01 * aux

    grads, vals = torch.func.vmap(torch.func.grad_and_value(loss),
                                  in_dims=(None, 0))(tp, torch.as_tensor(xs))
    for i in range(2):
        jv, jg = jax.value_and_grad(jloss)(jp, jnp.asarray(xs[i]))
        np.testing.assert_allclose(float(vals[i]), float(jv), rtol=1e-5)
        for g, e in zip(_leaves(tu.tree_map(lambda a: a[i], grads)),
                        _jleaves(jg)):
            _close(g, e)


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------

MLA = dict(kind="mla", num_heads=4, num_kv_heads=4, head_dim=32,
           kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16)
MLA_D = 48


def _mla(impl="naive", block_q=8, **over):
    jc = JL.AttnCfg(**dict(MLA, **over), impl=impl, block_q=block_q)
    tc = L.AttnCfg(**dict(MLA, **over), impl=impl, block_q=block_q)
    jp, _ = JL.init_attention(jax.random.PRNGKey(3), jc, MLA_D, jnp.float32)
    return jc, tc, jp, interop.params_to_torch(jp, "cpu")


@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("impl", ["naive", "blocked"])
def test_mla_train_matches_the_reference(impl, softcap):
    jc, tc, jp, tp = _mla(impl, logit_softcap=softcap)
    x = np.random.default_rng(0).normal(size=(2, 20, MLA_D)).astype(
        np.float32)
    pos = np.arange(20)[None]
    exp = JL.attention_train(jp, jc, jnp.asarray(x), jnp.asarray(pos))
    got = L.attention_train(tp, tc, torch.as_tensor(x), torch.as_tensor(pos))
    _close(got, exp)


@pytest.mark.parametrize("cache_len", [9, (3, 11)], ids=["scalar",
                                                         "per-slot"])
def test_mla_absorbed_decode_matches_the_reference(cache_len):
    """One token against a latent cache (random entries, T 16), a scalar
    or a per-slot ``cache_len``: output and both cache leaves."""
    jc, tc, jp, tp = _mla()
    rng = np.random.default_rng(1)
    cache = {"ckv": rng.normal(size=(2, 16, 32)).astype(np.float32),
             "k_rope": rng.normal(size=(2, 16, 8)).astype(np.float32)}
    x = rng.normal(size=(2, 1, MLA_D)).astype(np.float32)
    cl = np.asarray(cache_len, np.int32)
    jout, jcache = JL.attention_decode(
        jp, jc, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(cl))
    tcache = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    out, new = L.attention_decode(tp, tc, torch.as_tensor(x), tcache,
                                  torch.as_tensor(cl))
    _close(out, jout)
    for k in cache:
        assert new[k] is tcache[k]  # written in place
        _close(new[k], jcache[k])


def test_mla_decode_after_prefill_equals_the_forward(smokes):
    """deepseek-smoke (dense MLA prefix layer + MLA/MoE layer) at lossless
    capacity: prefill then teacher-forced decode steps give the full
    forward's logits at those positions, at rounding (the absorbed decode
    associates its products otherwise than the materialised prefill), and
    the reference's decode logits."""
    jcfg, jp, cfg, tp = smokes["deepseek_v3_671b"]
    jcfg, cfg = _lossless(jcfg, JL.MoECfg), _lossless(cfg, L.MoECfg)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16),
                                              dtype=np.int32)
    s = 12
    full, _, _ = T.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    logits, caches, cl = T.prefill(tp, cfg, {"tokens": torch.as_tensor(
        toks[:, :s])}, max_len=20)
    jlog, jc, jcl = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :s])},
                               max_len=20)
    _close(logits[:, -1], full[:, s - 1].detach(), 1e-5)
    for a, b in zip(_leaves(caches), _jleaves(jc)):
        _close(a, b)
    for i in range(s, 16):
        tok = toks[:, i:i + 1]
        lg, caches = T.decode_step(tp, cfg, caches, torch.as_tensor(tok), cl)
        jlg, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(tok), jcl)
        _close(lg[:, 0], full[:, i].detach(), 1e-5)
        _close(lg, jlg, 1e-4)
        cl, jcl = cl + 1, jcl + 1
    for a, b in zip(_leaves(caches), _jleaves(jc)):
        _close(a, b)


# ---------------------------------------------------------------------------
# the front ends
# ---------------------------------------------------------------------------


def _batch(jcfg, b=2, s=24, seed=3):
    ex = jspecs._example(jcfg, b, s, False, np.random.default_rng(seed))
    return ex, {k: _t(v) for k, v in ex.items()}


@pytest.mark.parametrize("arch", ["hubert_xlarge", "internvl2_26b"])
def test_front_end_embedding_matches_the_reference(smokes, arch):
    jcfg, jp, cfg, tp = smokes[arch]
    jb, tb = _batch(jcfg)
    jx, jpos = JT._embed_inputs(jp, jcfg, jb)
    x, pos = T._embed_inputs(tp, cfg, tb)
    _close(x, jx, 1e-6)
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    if cfg.frontend == "vision":
        n_img = jb["patches"].shape[1]
        assert x.shape[1] == n_img + jb["tokens"].shape[1]
        # the text part is the embedding rows, exactly
        assert torch.equal(x[:, n_img:], tp["embed"][tb["tokens"].long()])


@pytest.mark.parametrize("mask", ["specs", "none", "zeros"])
def test_audio_masked_loss_matches_the_reference(smokes, mask):
    """hubert's masked prediction: ``sum(nll * mask) / max(sum(mask), 1)``
    with the specs' mask, the mean without one, and 0 for an all-zero
    mask."""
    jcfg, jp, cfg, tp = smokes["hubert_xlarge"]
    jb, tb = _batch(jcfg)
    if mask == "none":
        del jb["mask"], tb["mask"]
    elif mask == "zeros":
        jb["mask"] = jnp.zeros_like(jb["mask"])
        tb["mask"] = torch.zeros_like(tb["mask"])
    else:
        assert 0 < float(tb["mask"].sum()) < tb["mask"].numel()
    exp = float(JT.loss_fn(jp, jcfg, jb))
    got = float(T.loss_fn(tp, cfg, tb))
    if mask == "zeros":
        assert got == exp == 0.0
    np.testing.assert_allclose(got, exp, rtol=1e-5)


def test_vision_loss_is_the_text_positions_only(smokes):
    """internvl2's loss is next-token CE over the text positions alone
    (``logits[:, s_img:-1]`` against ``tokens[:, 1:]``), and it matches the
    reference's."""
    jcfg, jp, cfg, tp = smokes["internvl2_26b"]
    jb, tb = _batch(jcfg)
    np.testing.assert_allclose(float(T.loss_fn(tp, cfg, tb)),
                               float(JT.loss_fn(jp, jcfg, jb)), rtol=1e-5)
    logits, _, _ = T.forward(tp, cfg, tb)
    s_img = tb["patches"].shape[1]
    own = T._ce(logits[:, s_img:-1], tb["tokens"][:, 1:])
    np.testing.assert_allclose(float(T.loss_fn(tp, cfg, tb)), float(own),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ["hubert_xlarge", "internvl2_26b"])
def test_front_end_prefill_and_decode_match_the_reference(smokes, arch):
    """prefill over features (hubert: the encoder's logits, every frame)
    or patches + tokens (internvl2: then teacher-forced decode steps),
    logits and caches against the reference's."""
    jcfg, jp, cfg, tp = smokes[arch]
    jb, tb = _batch(jcfg, s=20)
    jlog, jc, jcl = JT.prefill(jp, jcfg, jb, max_len=28)
    logits, caches, cl = T.prefill(tp, cfg, tb, max_len=28)
    S = 20 if cfg.frontend == "audio" else 5 + 15
    assert int(cl) == int(jcl) == S
    _close(logits, jlog, 1e-4)
    for a, b in zip(_leaves(caches), _jleaves(jc)):
        _close(a, b)
    if not cfg.decode_supported:
        return
    rng = np.random.default_rng(9)
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab, (2, 1), dtype=np.int32)
        lg, caches = T.decode_step(tp, cfg, caches, torch.as_tensor(tok), cl)
        jlg, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(tok), jcl)
        _close(lg, jlg, 1e-4)
        cl, jcl = cl + 1, jcl + 1
    for a, b in zip(_leaves(caches), _jleaves(jc)):
        _close(a, b)


# ---------------------------------------------------------------------------
# attention's plain versions at the new head dims, and the pad
# ---------------------------------------------------------------------------


def _qkv(b, s, h, kh, dk, dv, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, n, d)).astype(np.float32) * f
                 for n, d, f in ((h, dk, scale), (kh, dk, scale), (kh, dv, 1)))


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2)])
def test_plain_at_d80_not_causal_matches_interpreted_pallas(h, kh, softcap):
    """hubert's head dim, bidirectional, against the Pallas kernel in
    interpret mode (through the reference's GQA wrapper)."""
    q, k, v = _qkv(2, 48, h, kh, 80, 80, 0)
    exp = jops.gqa_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False,
                                   softcap=softcap, interpret=True)
    got = fa.flash_attention_bshd(*map(torch.as_tensor, (q, k, v)),
                                  causal=False, softcap=softcap)
    _close(got, exp)


def _jsdpa(q, k, v, causal, softcap):
    """The reference model's attention (``layers._sdpa``), scale
    ``1/sqrt(Dk)``: what the Pallas kernel cannot take when Dv != Dk."""
    s = q.shape[1]
    mask = JL.causal_mask(s, s)[None, None] if causal else None
    return JL._sdpa(q, k, v, mask, 1.0 / math.sqrt(q.shape[-1]), softcap)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dk,dv,h,kh", [(192, 128, 4, 4), (80, 80, 4, 2),
                                        (24, 16, 4, 4)])
def test_plain_forward_and_backward_at_new_head_dims(dk, dv, h, kh, causal):
    """MLA's Dk 192 / Dv 128 (and the smoke's 24 / 16), hubert's 80: the
    plain forward against ``_sdpa``, the plain backward against
    ``jax.vjp`` of it, and the rows' log-sum-exp against logsumexp."""
    q, k, v = _qkv(2, 40, h, kh, dk, dv, 1, scale=2.0)
    dout = np.random.default_rng(2).normal(size=(2, 40, h, dv)).astype(
        np.float32)
    exp, vjp = jax.vjp(lambda a, b, c: _jsdpa(a, b, c, causal, None),
                       *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    out, lse = fa.flash_attention_bshd(tq, tk, tv, causal=causal,
                                       with_lse=True)
    _close(out, exp)
    grads = fa.flash_attention_backward_plain(tq, tk, tv, out,
                                              torch.as_tensor(dout), lse,
                                              causal=causal)
    for g, e in zip(grads, vjp(jnp.asarray(dout))):
        _close(g, e)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("dk,dv,width", [(80, 80, 128), (192, 128, 256),
                                         (24, 16, 64), (128, 128, 128)])
def test_pad_to_the_kernel_width_changes_nothing(dk, dv, width, softcap):
    """The card's pad, through the plain versions: q, k and v zero-padded
    to the kernel's width and scaled by the true ``1/sqrt(Dk)`` give the
    unpadded output (sliced to Dv), row log-sum-exp and gradients (sliced
    to Dk, Dk, Dv)."""
    assert fa.kernel_width(dk, dv) == width
    q, k, v = map(torch.as_tensor, _qkv(2, 33, 4, 2, dk, dv, 3, scale=2.0))
    dout = torch.randn(2, 33, 4, dv, generator=torch.Generator()
                       .manual_seed(0))
    kw = dict(causal=True, window=20, softcap=softcap)
    (pq, pk, pv, pd), d = fa.to_kernel_width(q, k, v, dout)
    assert d == width and pq.shape[-1] == pk.shape[-1] == pv.shape[-1] == d
    if width == dk == dv:
        assert pq is q and pv is v
    scale = 1.0 / math.sqrt(dk)
    rep = lambda t: t.repeat_interleave(2, dim=2).transpose(1, 2)  # noqa
    out = fa.flash_attention_plain(q.transpose(1, 2), rep(k), rep(v),
                                   **kw).transpose(1, 2)
    pout = fa.flash_attention_plain(pq.transpose(1, 2), rep(pk), rep(pv),
                                    scale=scale, **kw).transpose(1, 2)
    torch.testing.assert_close(pout[..., :dv], out, rtol=1e-6, atol=1e-6)
    assert not pout[..., dv:].any()
    lse = fa.lse_plain(q, k, **kw)
    torch.testing.assert_close(fa.lse_plain(pq, pk, scale=scale, **kw), lse,
                               rtol=1e-6, atol=1e-6)
    grads = fa.flash_attention_backward_plain(q, k, v, out, dout, lse, **kw)
    pgrads = fa.flash_attention_backward_plain(pq, pk, pv, pout, pd, lse,
                                               scale=scale, **kw)
    for g, pg, n in zip(grads, pgrads, (dk, dk, dv)):
        torch.testing.assert_close(pg[..., :n], g, rtol=1e-5, atol=1e-6)
        assert not pg[..., n:].any()


def test_kernel_width_refuses_head_dims_past_256():
    assert [fa.kernel_width(d, d) for d in (1, 64, 65, 80, 128, 129, 256)] \
        == [64, 64, 128, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="head dim"):
        fa.kernel_width(320, 128)
    with pytest.raises(ValueError, match="head dim"):
        fa.kernel_width(128, 264)


def test_attention_autograd_takes_dv_other_than_dk():
    """``FlashAttention`` (the training path) with Dv != Dk: its gradient
    on CPU tensors equals autograd through the plain forward."""
    q, k, v = (torch.as_tensor(a).requires_grad_()
               for a in _qkv(2, 17, 4, 4, 24, 16, 5))
    out = fa.FlashAttention.apply(q, k, v, True, None, None)[0]
    (out * out).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    ref = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)
    (ref * ref).sum().backward()
    for g, t in zip(got, (q, k, v)):
        _close(g, t.grad.numpy())


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def test_generate_with_patches_matches_the_references(smokes):
    """internvl2-smoke: ``generate(..., extra_inputs={"patches": ...})``
    gives the reference's greedy tokens, logprobs at 1e-5."""
    jcfg, jp, cfg, tp = smokes["internvl2_26b"]
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab, (2, 10), dtype=np.int32)
    patches = np.asarray(jnp.asarray(rng.normal(size=(2, 4, 64)),
                                     jnp.float32))
    exp = JEngine(jcfg, jp, max_len=40).generate(
        prompts, max_new_tokens=8, extra_inputs={"patches": patches})
    eng = ServingEngine(cfg, tp, max_len=40, device="cpu")
    got = eng.generate(prompts, max_new_tokens=8,
                       extra_inputs={"patches": patches})
    np.testing.assert_array_equal(got.tokens, exp.tokens)
    np.testing.assert_allclose(got.logprobs, exp.logprobs, rtol=0, atol=1e-5)
    # tensors are taken too, and the patches matter
    again = eng.generate(prompts, max_new_tokens=8, extra_inputs={
        "patches": torch.as_tensor(patches.copy())})
    np.testing.assert_array_equal(again.tokens, got.tokens)
    other = eng.generate(prompts, max_new_tokens=8, extra_inputs={
        "patches": np.zeros_like(patches)})
    assert not np.allclose(other.logprobs, got.logprobs)


def test_serve_refuses_front_ends_and_the_engine_refuses_encoders(smokes):
    """The reference's ``serve`` takes token prompts alone; the port's
    refuses a vision model instead of failing on its missing patches.
    hubert has no decode step: both engines refuse it."""
    jcfg, jp, cfg, tp = smokes["internvl2_26b"]
    eng = ServingEngine(cfg, tp, max_len=40, device="cpu")
    req = [Request(id=0, prompt=np.arange(6, dtype=np.int32))]
    with pytest.raises(ValueError, match="extra_inputs"):
        eng.serve(req)
    with pytest.raises(KeyError, match="patches"):
        JEngine(jcfg, jp, max_len=40).serve([JRequest(
            id=0, prompt=np.arange(6, dtype=np.int32))])
    jcfg, jp, cfg, tp = smokes["hubert_xlarge"]
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(cfg, tp, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        JEngine(jcfg, jp)


@pytest.mark.parametrize("arch", ["grok_1_314b", "deepseek_v3_671b"])
def test_moe_generate_matches_the_references(smokes, arch):
    """grok-smoke (GQA + MoE, softcaps) and deepseek-smoke (MLA, dense
    prefix, MoE with a shared expert) at their own capacity: greedy tokens
    and logprobs against the reference's generate."""
    jcfg, jp, cfg, tp = smokes[arch]
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 12),
                                                dtype=np.int32)
    exp = JEngine(jcfg, jp, max_len=40).generate(prompts, max_new_tokens=8)
    got = ServingEngine(cfg, tp, max_len=40, device="cpu").generate(
        prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, exp.tokens)
    np.testing.assert_allclose(got.logprobs, exp.logprobs, rtol=0, atol=1e-4)


def test_grok_serve_at_lossless_capacity_matches_sequential(smokes):
    """Continuous batching == sequential generate for the MoE model once
    no pair is dropped (capacity couples a batch's rows otherwise), and
    the reference's serve gives the same tokens."""
    jcfg, jp, cfg, tp = smokes["grok_1_314b"]
    jcfg, cfg = _lossless(jcfg, JL.MoECfg), _lossless(cfg, L.MoECfg)
    rng = np.random.default_rng(3)
    lens, news = (7, 12, 9), (6, 4, 7)
    eng = ServingEngine(cfg, tp, max_len=48, device="cpu")
    reqs = [Request(id=i, prompt=rng.integers(0, cfg.vocab, n,
                                              dtype=np.int32),
                    max_new_tokens=m) for i, (n, m) in enumerate(zip(lens,
                                                                     news))]
    res = eng.serve(reqs, slots=2, segment=3)
    jres = JEngine(jcfg, jp, max_len=48).serve(
        [JRequest(id=r.id, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
         for r in reqs], slots=2, segment=3)
    for r, jr in zip(res, jres):
        seq = eng.generate(reqs[r.id].prompt[None],
                           max_new_tokens=reqs[r.id].max_new_tokens)
        np.testing.assert_array_equal(r.tokens, seq.tokens[0])
        np.testing.assert_array_equal(r.tokens, jr.tokens)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_combine_is_the_references_scatter_add_bitwise(dtype):
    """The combine adds a token's K weighted slot outputs in order k = 0..K-1
    from zero: bit for bit the reference's ``.at[tok_idx].add`` on the CPU,
    dropped pairs (``keep`` False) adding zero."""
    E, C, d, T, K = 4, 6, 16, 10, 3
    rng = np.random.default_rng(11)
    eout = rng.normal(size=(E, C, d)).astype(np.float32)
    flat_e = rng.integers(0, E, T * K)
    slot = rng.integers(0, C, T * K)
    keep = rng.uniform(size=T * K) < 0.8
    gates = rng.uniform(size=(T, K)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    je = jnp.asarray(eout, jdt)
    gathered = jnp.where(keep[:, None], je[flat_e, slot], 0.0)
    w = jnp.asarray(gates).reshape(-1)[:, None].astype(gathered.dtype)
    exp = jnp.zeros((T, d), gathered.dtype).at[np.repeat(np.arange(T), K)] \
        .add(gathered * w)
    got = L.moe_combine(_t(np.asarray(je)), torch.as_tensor(flat_e),
                        torch.as_tensor(slot), torch.as_tensor(keep),
                        torch.as_tensor(gates))
    assert got.dtype == tdt
    assert _same_bits(got, exp)


def test_mla_serve_matches_sequential_at_rounding(smokes):
    """deepseek-smoke at lossless capacity: continuous batching gives the
    sequential ``generate``'s greedy tokens, and its logprobs within 1e-5
    -- not bitwise: the absorbed decode's products at batch 2 and batch 1
    round differently on the CPU, which is why the reference leaves MLA
    out of its bitwise batched-decode parity (tests/test_serving.py)."""
    _, _, cfg, tp = smokes["deepseek_v3_671b"]
    cfg = _lossless(cfg, L.MoECfg)
    rng = np.random.default_rng(3)
    eng = ServingEngine(cfg, tp, max_len=48, device="cpu")
    reqs = [Request(id=i, prompt=rng.integers(0, cfg.vocab, n,
                                              dtype=np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(((7, 6), (12, 4), (9, 7)))]
    for r in eng.serve(reqs, slots=2, segment=3):
        seq = eng.generate(reqs[r.id].prompt[None],
                           max_new_tokens=reqs[r.id].max_new_tokens)
        np.testing.assert_array_equal(r.tokens, seq.tokens[0])
        np.testing.assert_allclose(r.logprobs, seq.logprobs[0], rtol=0,
                                   atol=1e-5)
