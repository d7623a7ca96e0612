"""The port's recurrent and state-space layers against the JAX reference:
the RG-LRU scan and block (recurrentgemma), the Mamba2 SSD and block, the
causal depthwise conv, decode after short prompts, the long-context
variant and ``configs/base.py``.

Inputs come from numpy seeds; block params from the reference's
``init_*`` through :mod:`repro_torch.interop`; float32 throughout, on the
CPU.  Tolerances:

  * the scan: rtol 1e-5 / atol 1e-6 against ``_rglru_scan`` (XLA's
    ``associative_scan``) and against a sequential loop (measured <= 9.6e-7
    absolute at S = 257): the doubling scan multiplies in another order;
  * the causal conv: bitwise (the same taps summed in the same order);
  * the SSD, the blocks and the decode steps: within ``1e-5 * max |.|``
    of the reference's (measured <= 2.4e-6, the SSD in one 48-step chunk;
    the blocks <= 5.8e-7: the contractions sum in other orders);
  * decode after a prompt against the teacher-forced forward over the
    prompt and its continuation: logits within ``1e-5 * max |logit|``
    (measured <= 6.1e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.engine import _splice_caches
from repro_torch.utils import tree as tu

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _assert_rel(got, exp, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    exp = np.asarray(exp)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=0,
                               atol=tol * float(np.abs(exp).max()))


def _scan_loop(a, b, h0=None):
    h = np.zeros_like(b[:, 0]) if h0 is None else h0.astype(np.float64)
    out = []
    for t in range(b.shape[1]):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        out.append(h)
    return np.stack(out, 1)


# ---------------------------------------------------------------------------
# the RG-LRU scan and the conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("s", [1, 2, 24, 257])
def test_rglru_scan_matches_jax_and_a_loop(s, h0):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 0.99, (2, s, 16)).astype(np.float32)
    b = rng.standard_normal((2, s, 16)).astype(np.float32)
    h = rng.standard_normal((2, 16)).astype(np.float32) if h0 else None
    got = L._rglru_scan(_t(a), _t(b), None if h is None else _t(h)).numpy()
    exp = np.asarray(JL._rglru_scan(jnp.asarray(a), jnp.asarray(b),
                                    None if h is None else jnp.asarray(h)))
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _scan_loop(a, b, h), rtol=1e-5,
                               atol=1e-6)


def test_linear_scan_broadcasts_a_and_composes_with_vmap_and_grad():
    """The SSD's chunk recurrence: ``a`` (B, n, H, 1, 1) against ``b`` (B,
    n, H, N, P); under ``vmap`` it equals the per-row call bitwise, and
    ``grad`` through it equals the loop's gradient."""
    rng = np.random.default_rng(3)
    a = _t(rng.uniform(0.1, 1.0, (3, 9, 2, 1, 1)).astype(np.float32))
    b = _t(rng.standard_normal((3, 9, 2, 4, 5)).astype(np.float32))
    got = L._linear_scan(a, b, dim=1)
    exp = _scan_loop(a.expand_as(b).flatten(2).numpy(),
                     b.flatten(2).numpy()).reshape(b.shape)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6)
    mapped = torch.func.vmap(lambda x, y: L._linear_scan(x, y, dim=0))(a, b)
    assert torch.equal(mapped, got)

    def loop(a, b):
        h, out = torch.zeros_like(b[:, 0]), []
        for t in range(b.shape[1]):
            h = a[:, t] * h + b[:, t]
            out.append(h)
        return torch.stack(out, 1)

    w = _t(rng.standard_normal(b.shape).astype(np.float32))
    ga = torch.func.grad(lambda a_: (L._linear_scan(a_, b) * w).sum())(a)
    ea = torch.func.grad(lambda a_: (loop(a_, b) * w).sum())(a)
    torch.testing.assert_close(ga, ea, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_is_the_references_bitwise(with_state):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    args = (jnp.asarray(st),) if with_state else ()
    jy, jst = JL._causal_conv1d(jnp.asarray(x), jnp.asarray(w), *args)
    y, nst = L._causal_conv1d(_t(x), _t(w), _t(st) if with_state else None)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(nst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("s", [1, 2, 3, 9])
def test_conv_tail_left_pads_a_short_prompt(s):
    u = torch.arange(2 * s * 5, dtype=torch.float32).reshape(2, s, 5) + 1
    tail = L.conv_tail(u, 4)
    assert tail.shape == (2, 3, 5)
    k = min(s, 3)
    assert torch.equal(tail[:, 3 - k:], u[:, s - k:])
    assert not tail[:, :3 - k].any()


# ---------------------------------------------------------------------------
# the SSD
# ---------------------------------------------------------------------------


def _ssd_inputs(l, seed=0, b=2, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, (h,)).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)
    D = rng.standard_normal((h,)).astype(np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("l,chunk", [(64, 16), (70, 16), (5, 16), (1, 8),
                                     (48, 48)],
                         ids=["chunks", "ragged", "short", "one", "single"])
def test_ssd_chunked_with_state_matches_jax(l, chunk):
    ins = _ssd_inputs(l, seed=l)
    jy, jst = JL.ssd_chunked_with_state(*map(jnp.asarray, ins), chunk)
    y, st = L.ssd_chunked_with_state(*map(_t, ins), chunk)
    _assert_rel(y, jy)
    _assert_rel(st, jst)
    torch.testing.assert_close(L.ssd_chunked(*map(_t, ins), chunk), y,
                               rtol=0, atol=0)


def test_ssd_final_state_continues_as_the_decode_recurrence():
    """The final state of a prefix, stepped on with the decode's recurrence
    (h' = decay h + dt B x^T, y = C.h' + D x), gives the full sequence's
    outputs: chunked and sequential forms agree."""
    ins = _ssd_inputs(40, seed=9)
    x, dt, A, B, C, D = map(_t, ins)
    y_full, _ = L.ssd_chunked_with_state(x, dt, A, B, C, D, 16)
    _, h = L.ssd_chunked_with_state(x[:, :30], dt[:, :30], A, B[:, :30],
                                    C[:, :30], D, 16)
    for t in range(30, 40):
        decay = torch.exp(A[None] * dt[:, t])
        h = (h * decay[..., None, None]
             + torch.einsum("bhp,bn,bh->bhpn", x[:, t], B[:, t], dt[:, t]))
        y = torch.einsum("bhpn,bn->bhp", h, C[:, t]) + x[:, t] * D[:, None]
        torch.testing.assert_close(y, y_full[:, t], rtol=0,
                                   atol=TOL * float(y_full.abs().max()))


def test_segsum_and_ssd_gradients_are_finite_and_match_jax():
    """The -inf above _segsum's diagonal gives finite gradients through
    exp under ``torch.func.grad``, equal to ``jax.grad``'s."""
    rng = np.random.default_rng(11)
    a = -rng.uniform(0.0, 1.0, (2, 3, 8)).astype(np.float32)
    w = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    g = torch.func.grad(
        lambda x: (torch.exp(L._segsum(x)) * _t(w)).sum())(_t(a))
    jg = jax.grad(lambda x: (jnp.exp(JL._segsum(x)) * w).sum())(
        jnp.asarray(a))
    assert torch.isfinite(g).all()
    _assert_rel(g, jg)

    ins = _ssd_inputs(37, seed=12)
    wy = rng.standard_normal((2, 37, 3, 4)).astype(np.float32)

    def tloss(x, dt, A):
        y, st = L.ssd_chunked_with_state(x, dt, A, *map(_t, ins[3:]), 16)
        return (y * _t(wy)).sum() + st.sum()

    def jloss(x, dt, A):
        y, st = JL.ssd_chunked_with_state(x, dt, A,
                                          *map(jnp.asarray, ins[3:]), 16)
        return (y * wy).sum() + st.sum()

    grads = torch.func.grad(tloss, argnums=(0, 1, 2))(*map(_t, ins[:3]))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, ins[:3]))
    for got, exp in zip(grads, jgrads):
        assert torch.isfinite(got).all()
        _assert_rel(got, exp)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def _block(kind):
    """(reference cfg, reference params, port params, d_model) of the
    smoke config's mixer, float32."""
    if kind == "rec":
        cfg = jreg.get_smoke("recurrentgemma_9b")
        mcfg = cfg.rglru
        jp, _ = JL.init_rglru_block(jax.random.PRNGKey(1), mcfg, cfg.d_model,
                                    jnp.float32)
    else:
        cfg = jreg.get_smoke("mamba2_130m")
        mcfg = cfg.ssm
        jp, _ = JL.init_mamba2_block(jax.random.PRNGKey(2), mcfg,
                                     cfg.d_model, jnp.float32)
    tcfg = (L.RGLRUCfg(**dataclasses.asdict(mcfg)) if kind == "rec"
            else L.SSMCfg(**dataclasses.asdict(mcfg)))
    return mcfg, jp, tcfg, interop.params_to_torch(jp, "cpu"), cfg.d_model


BLOCKS = {"rec": (JL.rglru_block_train, JL.rglru_block_decode,
                  L.rglru_block_train, L.rglru_block_decode,
                  JL.init_rglru_cache, L.init_rglru_cache),
          "ssm": (JL.mamba2_train, JL.mamba2_decode, L.mamba2_train,
                  L.mamba2_decode, JL.init_mamba2_cache,
                  L.init_mamba2_cache)}


@pytest.mark.parametrize("s", [1, 40, 70])
@pytest.mark.parametrize("kind", ["rec", "ssm"])
def test_block_train_matches_jax(kind, s):
    jtrain, _, train, _, _, _ = BLOCKS[kind]
    jcfg, jp, cfg, tp, d = _block(kind)
    x = np.random.default_rng(s).standard_normal((2, s, d)).astype(
        np.float32)
    _assert_rel(train(tp, cfg, _t(x)), jtrain(jp, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["rec", "ssm"])
def test_block_decode_matches_jax_and_train(kind):
    """Ten decode steps from a zero cache against the reference's decode
    (outputs and the carried state) and against the full-sequence block:
    the cache is written in place."""
    jtrain, jdecode, train, decode, jinit, init = BLOCKS[kind]
    jcfg, jp, cfg, tp, d = _block(kind)
    x = np.random.default_rng(7).standard_normal((2, 10, d)).astype(
        np.float32)
    jc, _ = (jinit(jcfg, d, 2, jnp.float32) if kind == "rec"
             else jinit(jcfg, 2, jnp.float32))
    c = (init(cfg, d, 2, torch.float32) if kind == "rec"
         else init(cfg, 2, torch.float32))
    ptrs = [t.data_ptr() for t in tu.tree_leaves(c)]
    full = train(tp, cfg, _t(x))
    for t in range(10):
        jy, jc = jdecode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        y, out = decode(tp, cfg, _t(x[:, t:t + 1]), c)
        assert out is c and [a.data_ptr() for a in tu.tree_leaves(c)] == ptrs
        _assert_rel(y, jy)
        torch.testing.assert_close(y[:, 0], full[:, t], rtol=0,
                                   atol=TOL * float(full.abs().max()))
    for a, b in zip(jax.tree_util.tree_leaves(jc), tu.tree_leaves(c)):
        _assert_rel(b, a)


# ---------------------------------------------------------------------------
# decode after short prompts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_params():
    out = {}
    for arch in ("mamba2_130m", "recurrentgemma_9b"):
        jcfg = jreg.get_smoke(arch).with_overrides(param_dtype=jnp.float32)
        jp, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
        cfg = registry.get_smoke(arch).with_overrides(
            param_dtype=torch.float32)
        out[arch] = (cfg, interop.params_to_torch(jp, "cpu"))
    return out


@pytest.mark.parametrize("s", [1, 2, 3, 5])
@pytest.mark.parametrize("arch", ["mamba2_130m", "recurrentgemma_9b"])
def test_decode_after_a_short_prompt_equals_the_forward(smoke_params, arch,
                                                        s):
    """Prefill of ``s`` tokens (fewer than conv_width - 1 = 3 for s = 1, 2:
    the conv state is zero-padded on the left) then 6 decode steps, each
    step's logits against the teacher-forced forward over the prompt and
    its continuation.  The reference's mamba2 keeps a short conv state
    there and its next decode step raises (ROADMAP Queue 3)."""
    cfg, tp = smoke_params[arch]
    steps = 6
    toks = torch.from_numpy(np.random.default_rng(s).integers(
        0, cfg.vocab, (2, s + steps), dtype=np.int32))
    full, _, _ = T.forward(tp, cfg, {"tokens": toks})
    logits, caches, cl = T.prefill(tp, cfg, {"tokens": toks[:, :s]},
                                   max_len=16)
    tol = TOL * float(full.abs().max())
    torch.testing.assert_close(logits[:, -1], full[:, s - 1], rtol=0,
                               atol=tol)
    for leaf in tu.tree_leaves(caches):
        assert torch.isfinite(leaf).all()
    conv = caches["stack"]["b0"]["conv"]
    assert conv.shape[2] == 3
    if s < 3:
        assert not conv[:, :, :3 - s].any()
    for i in range(steps):
        lg, caches = T.decode_step(tp, cfg, caches, toks[:, s + i:s + i + 1],
                                   cl)
        torch.testing.assert_close(lg[:, 0], full[:, s + i], rtol=0,
                                   atol=tol)
        cl = cl + 1


@pytest.mark.parametrize("arch", ["mamba2_130m", "recurrentgemma_9b"])
def test_a_splice_replaces_the_state_of_a_finished_slot(smoke_params, arch):
    """A slot whose request finished keeps decoding in continuous batching,
    so its state caches drift; splicing the next request's prefill
    overwrites the whole row, bitwise, and leaves the other rows alone."""
    cfg, tp = smoke_params[arch]
    rng = np.random.default_rng(21)
    pool = T.init_cache(cfg, 2, 32, "cpu")
    _, one, cl = T.prefill(tp, cfg, {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, 9), dtype=np.int32))}, max_len=32)
    _splice_caches(pool, one, 0)
    _splice_caches(pool, one, 1)
    cl = torch.full((2,), int(cl), dtype=torch.int32)
    for _ in range(5):  # both slots decode on; slot 1's request is done
        _, pool = T.decode_step(tp, cfg, pool, torch.zeros(
            (2, 1), dtype=torch.int32), cl)
        cl = cl + 1
    drifted = [x[:, 1].clone() for x in tu.tree_leaves(pool["stack"])]
    row0 = [x[:, 0].clone() for x in tu.tree_leaves(pool["stack"])]
    assert any(not torch.equal(d, s[:, 0]) for d, s in
               zip(drifted, tu.tree_leaves(one["stack"])))
    _, nxt, _ = T.prefill(tp, cfg, {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, 2), dtype=np.int32))}, max_len=32)
    _splice_caches(pool, nxt, 1)
    for d, s_, r0 in zip(tu.tree_leaves(pool["stack"]),
                         tu.tree_leaves(nxt["stack"]), row0):
        assert torch.equal(d[:, 1], s_[:, 0])
        assert torch.equal(d[:, 0], r0)


# ---------------------------------------------------------------------------
# configs/base.py and the long-context variant
# ---------------------------------------------------------------------------


def test_shapes_are_the_references():
    assert list(base.SHAPES) == list(jbase.SHAPES)
    for name, shape in base.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jbase.SHAPES[name])


def _variant_fields(cfg):
    attn = None if cfg.attn is None else (cfg.attn.window, cfg.attn.num_heads,
                                          cfg.attn.head_dim)
    return (cfg.name, attn, cfg.window_local, cfg.long_mode,
            cfg.long_window, cfg.decode_supported)


@pytest.mark.parametrize("shape", list(base.SHAPES))
@pytest.mark.parametrize("arch", registry.PORTED)
def test_long_context_variant_and_shape_supported_are_the_references(arch,
                                                                     shape):
    for get in ("get", "get_smoke"):
        t, j = getattr(registry, get)(arch), getattr(jreg, get)(arch)
        assert base.shape_supported(t, base.SHAPES[shape]) == \
            jbase.shape_supported(j, jbase.SHAPES[shape])
        if shape == "long_500k" and t.long_mode == "skip":  # hubert
            for cfg in (t, j):
                with pytest.raises(ValueError, match="long context"):
                    cfg.long_context_variant()
        elif shape == "long_500k":
            t, j = t.long_context_variant(), j.long_context_variant()
        assert _variant_fields(t) == _variant_fields(j)


def test_skip_mode_refuses_long_context_in_both_packages():
    t = registry.get_smoke("phi3_medium_14b").with_overrides(long_mode="skip")
    j = jreg.get_smoke("phi3_medium_14b").with_overrides(long_mode="skip")
    for cfg, mod in ((t, base), (j, jbase)):
        ok, why = mod.shape_supported(cfg, mod.SHAPES["long_500k"])
        assert not ok and "long-context" in why
        with pytest.raises(ValueError, match="long context"):
            cfg.long_context_variant()


def test_registry_ports_the_three_new_archs_and_refuses_the_rest():
    """The three archs of the recurrent slice are ported with the
    reference's citation; names outside the reference's registry are
    refused by both packages."""
    for arch in ("phi3_medium_14b", "recurrentgemma_9b", "mamba2_130m"):
        assert arch in registry.PORTED
        assert registry.get(arch).citation == jreg.get(arch).citation
    for arch in ("llama_7b", "grok-2"):
        for reg in (registry, jreg):
            with pytest.raises(KeyError, match="unknown arch"):
                reg.get(arch)
