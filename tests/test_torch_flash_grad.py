"""The gradient of the port's flash attention on the CPU: the plain backward
(``flash_attention_backward_plain``, the formula kernel 5b computes) against
``torch.autograd`` through the plain forward and against ``jax.grad`` of the
reference's ``repro.kernels.ref.flash_attention``; the autograd Functions
(``FlashAttention``, ``FlashAttentionBackward``) under ``torch.func`` with
their vmap rules; the backward kernel's query-tile walk.

Inputs come from numpy seeds.  Tolerances: float32 gradients within
``1e-5 * max |grad|`` of each other (measured <= 2e-6: the two sides sum the
same products in different orders); the vmap rules fold the mapped axis into
B, so a vmapped call equals the per-client loop bitwise on the CPU.  The
kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa

B, S, H, KH, D = 2, 64, 4, 2, 32
TOL = 1e-5
MASKS = {"causal": dict(causal=True),
         "window": dict(causal=True, window=9),
         "softcap": dict(causal=True, softcap=5.0),
         "not causal": dict(causal=False)}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _inputs(seed=0, b=B, s=S, h=H, kh=KH, d=D, scale=2.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32) * scale
    k = rng.normal(size=(b, s, kh, d)).astype(np.float32) * scale
    v = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _rel(got, exp) -> float:
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


@pytest.mark.parametrize("mask", list(MASKS))
def test_plain_backward_matches_autograd_of_the_plain_forward(mask):
    kw = MASKS[mask]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1))
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention_bshd(q, k, v, **kw)
    exp = torch.autograd.grad(out, (q, k, v), do)
    got = fa.flash_attention_backward_plain(q.detach(), k.detach(),
                                            v.detach(), out.detach(), do,
                                            **kw)
    for g, e in zip(got, exp):
        assert g.dtype == torch.float32 and g.shape == e.shape
        assert _rel(g, e) <= TOL


@pytest.mark.parametrize("mask", list(MASKS))
def test_plain_backward_matches_jax_grad_of_the_reference(mask):
    """``jax.grad`` of ``repro.kernels.ref.flash_attention`` (kv heads
    repeated, as the reference's ops wrapper does), in float32."""
    kw = MASKS[mask]
    q, k, v, do = _inputs(2)
    rep = H // KH

    def jloss(q, k, v):
        kr, vr = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        out = jref.flash_attention(q.transpose(0, 2, 1, 3),
                                   kr.transpose(0, 2, 1, 3),
                                   vr.transpose(0, 2, 1, 3), **kw)
        return jnp.sum(out.transpose(0, 2, 1, 3) * do)

    with jax.enable_x64(False):
        exp = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = fa.flash_attention_bshd(tq, tk, tv, **kw)
    got = fa.flash_attention_backward_plain(tq, tk, tv, out,
                                            torch.from_numpy(do), **kw)
    for g, e in zip(got, exp):
        assert _rel(g.numpy(), e) <= TOL


@pytest.mark.parametrize("mask", list(MASKS))
def test_lse_is_the_rows_log_sum_exp(mask):
    """What the forward hands the backward: float32 ``(B, H, S)``, from the
    same logits as the forward; with it the plain backward is the one
    without."""
    kw = MASKS[mask]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3))
    out, lse = fa.flash_attention_bshd(q, k, v, with_lse=True, **kw)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    torch.testing.assert_close(out, fa.flash_attention_bshd(q, k, v, **kw),
                               rtol=0, atol=0)
    kr = k.repeat_interleave(H // KH, dim=2)
    x = torch.einsum("bshd,bthd->bhst", q.double(), kr.double()) / D ** 0.5
    if kw.get("softcap"):
        x = kw["softcap"] * torch.tanh(x / kw["softcap"])
    mask_ = fa._mask(S, kw["causal"], kw.get("window"), "cpu")
    if mask_ is not None:
        x = x.masked_fill(~mask_, -torch.inf)
    assert _rel(lse, torch.logsumexp(x, -1)) <= TOL
    a = fa.flash_attention_backward_plain(q, k, v, out, do, lse, **kw)
    b = fa.flash_attention_backward_plain(q, k, v, out, do, **kw)
    for x_, y in zip(a, b):
        assert _rel(x_, y) <= TOL


def _client_loss(p, kw):
    out = ops.gqa_flash_attention(p["q"], p["k"], p["v"], **kw)
    return torch.sum(out * out * p["w"])


@pytest.mark.parametrize("mask", list(MASKS))
def test_vmap_of_grad_through_the_functions_equals_a_client_loop(mask):
    """``vmap(grad_and_value)`` over 3 clients runs both Functions' vmap
    rules (the forward's, and the backward's from inside the forward's
    backward); on CPU tensors the kernels' plain versions run, no launch."""
    kw = MASKS[mask]
    rng = np.random.default_rng(4)
    n = 3
    p = {"q": rng.normal(size=(n, B, S, H, D)),
         "k": rng.normal(size=(n, B, S, KH, D)),
         "v": rng.normal(size=(n, B, S, KH, D)),
         "w": rng.normal(size=(n, B, S, H, D))}
    p = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    before = (_build.COUNTS["flash_attentions"],
              _build.COUNTS["flash_attention_bwds"])
    grads, loss = torch.func.vmap(torch.func.grad_and_value(
        lambda p: _client_loss(p, kw)))(p)
    assert (_build.COUNTS["flash_attentions"],
            _build.COUNTS["flash_attention_bwds"]) == before
    for i in range(n):
        pi = {k: v[i].clone().requires_grad_() for k, v in p.items()}
        li = _client_loss(pi, kw)
        li.backward()
        torch.testing.assert_close(loss[i], li.detach(), rtol=0, atol=0)
        for name in ("q", "k", "v"):
            torch.testing.assert_close(grads[name][i], pi[name].grad,
                                       rtol=0, atol=0)


def test_vmap_with_an_unmapped_operand_expands_it():
    """k, v shared by every client (``in_dims`` None): the rule expands
    them along the folded axis; their gradient sums over the clients."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(3, B, S, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, KH, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, KH, D)).astype(np.float32))

    def f(q, k, v):
        return torch.sum(ops.gqa_flash_attention(q, k, v, window=9) ** 2)

    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)),
                          in_dims=(0, None, None))(q, k, v)
    for i in range(3):
        exp = torch.func.grad(f, argnums=(0, 1, 2))(q[i], k, v)
        for g, e in zip(got, exp):
            torch.testing.assert_close(g[i], e, rtol=1e-6, atol=1e-6)


def test_low_precision_under_autograd_raises_and_serving_does_not():
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    assert ops.gqa_flash_attention(q, q, q).dtype == torch.bfloat16
    qg = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="float32"):
        ops.gqa_flash_attention(qg, q, q)
    with torch.no_grad():
        assert ops.gqa_flash_attention(qg, q, q).shape == q.shape
    with pytest.raises(NotImplementedError, match="float32"):
        fa.flash_attention_bshd(q, q, q, with_lse=True)


def test_backward_wrapper_cpu_is_plain_and_other_devices_raise():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(6))
    out, lse = fa.flash_attention_bshd(q, k, v, with_lse=True)
    before = _build.COUNTS["flash_attention_bwds"]
    got = fa.flash_attention_bwd(q, k, v, out, do, lse)
    exp = fa.flash_attention_backward_plain(q, k, v, out, do, lse)
    assert _build.COUNTS["flash_attention_bwds"] == before
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    m = q.to("meta")
    with pytest.raises(ValueError, match="no flash_attention backward"):
        fa.flash_attention_bwd(m, m[:, :, :KH], m[:, :, :KH], m, m,
                               lse.to("meta"))
    with pytest.raises(NotImplementedError, match="second derivative"):
        fa.FlashAttentionBackward.backward(None)


# (query rows, keys) of the tiles the backward kernels walk, at every head
# dim: the dK/dV kernel's key block and its query tiles, the dQ kernel's
# query block and its kv tiles
_BWD_TILES = sorted({t for d in fa.HEAD_DIMS
                     for t in fa.bwd_tiles(d).values()})


@pytest.mark.parametrize("bq,bk", _BWD_TILES)
@pytest.mark.parametrize("s", [1, 31, 32, 33, 64, 65, 100, 129, 200])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 1),
                                           (True, 7), (True, 40),
                                           (False, None)])
def test_q_tile_range_holds_exactly_the_rows_a_kv_tile_needs(s, causal,
                                                             window, bq, bk):
    """The backward's dk/dv walk (``q_tile_range``, mirrored by the
    kernel's ``q_tiles``) and its dq walk (``kv_tile_range``), with query
    tiles of ``bq`` rows and kv tiles of ``bk`` keys: every tile with an
    admitted pair is visited, and only tiles touching the mask's admitted
    band (the first and last may hold refused pairs)."""
    mask = fa._mask(s, causal, window, "cpu")
    mask = torch.ones(s, s, dtype=torch.bool) if mask is None else mask
    nq, nk = -(-s // bq), -(-s // bk)
    for kt in range(nk):
        t0, t1 = fa.q_tile_range(s, kt * bk, bk, bq, causal=causal,
                                 window=window)
        need = [qt for qt in range(nq)
                if mask[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk].any()]
        assert list(range(t0, t1)) == need, (kt, t0, t1, need)
    for qt in range(nq):
        t0, t1 = fa.kv_tile_range(s, qt * bq, bq, bk, causal=causal,
                                  window=window)
        need = [kt for kt in range(nk)
                if mask[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk].any()]
        assert list(range(t0, t1)) == need, (qt, t0, t1, need)


# ---------------------------------------------------------------------------
# the launch path of both wrappers, with a mocked library
# ---------------------------------------------------------------------------


class _FakeLibrary:
    """The flash entries, recording their arguments and returning ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def repro_flash_attention(self, *args):
        self.calls.append(("fwd",) + args)
        return self.rc

    def repro_flash_attention_bwd(self, *args):
        self.calls.append(("bwd",) + args)
        return self.rc


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the card's path into a fake library (the launch
    goes through ``_build.launch`` on a fake stream 7)."""
    def install(lib):
        monkeypatch.setattr(_build, "on_card", lambda name, t: True)
        monkeypatch.setattr(_build, "load_library", lambda: lib)
        monkeypatch.setattr(_build, "stream_handle", lambda index: 7)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
        return lib
    return install


def test_forward_launch_marshals_the_entry_and_the_lse(fake_card):
    """One call of ``repro_flash_attention`` with the dtype code, five
    pointers (the lse's only when asked for), 12 strides, B, S, H, K, D,
    causal, the window (0 when not causal), scale, softcap and the
    stream: 28 arguments, as ``_build.load_library`` declares them."""
    lib = fake_card(_FakeLibrary())
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(7, d=64))
    before = _build.COUNTS["flash_attentions"]
    fa.flash_attention_bshd(q, k, v, window=9, softcap=5.0)
    out, lse = fa.flash_attention_bshd(q, k, v, causal=False, window=9,
                                       with_lse=True)
    assert _build.COUNTS["flash_attentions"] == before + 2
    (_, *a), (_, *b) = lib.calls
    assert len(a) == len(b) == 28
    assert a[0] == 0 and a[5] is None and b[5] == lse.data_ptr()
    assert a[18:25] == [B, S, H, KH, 64, 1, 9] and b[23:25] == [0, 0]
    assert a[25] == pytest.approx(64 ** -0.5) and a[26] == 5.0
    assert b[26] == 0.0 and a[27] == b[27] == 7
    assert lse.shape == (B, H, S) and out.shape == q.shape


def test_backward_launch_marshals_the_entry(fake_card):
    lib = fake_card(_FakeLibrary())
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(8, d=64))
    lse = torch.zeros(B, H, S)
    before = _build.COUNTS["flash_attention_bwds"]
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, q, do, lse, window=9,
                                        softcap=5.0)
    assert _build.COUNTS["flash_attention_bwds"] == before + 1
    (_, *a), = lib.calls
    assert len(a) == 20
    assert a[:6] == [t.data_ptr() for t in (q, k, v, q, do, lse)]
    assert a[7:10] == [t.data_ptr() for t in (dq, dk, dv)]
    assert a[10:17] == [B, S, H, KH, 64, 1, 9]
    assert a[17] == pytest.approx(64 ** -0.5) and a[18] == 5.0 and a[19] == 7
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)


def test_backward_launch_hands_aligned_contiguous_operands(fake_card):
    """The kernels read rows with 16-byte copies: a contiguous view that
    starts off a 16-byte boundary is copied first, an aligned one is passed
    in place."""
    lib = fake_card(_FakeLibrary())
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(8, d=64))
    flat = torch.cat([torch.zeros(1), q.flatten()])
    q_off = flat[1:].view(q.shape)  # contiguous, 4 bytes off
    assert q_off.is_contiguous() and q_off.data_ptr() % 16
    fa.flash_attention_bwd(q_off, k, v, q, do, torch.zeros(B, H, S))
    (_, *a), = lib.calls
    assert all(p % 16 == 0 for p in a[:10])
    assert a[0] != q_off.data_ptr() and a[1] == k.data_ptr()


@pytest.mark.parametrize("rc,match", [
    (1000, "flash_attention kernel: cuTensorMapEncodeTiled refused"),
    (700, "flash_attention kernel launch failed: cudaError 700")])
def test_refused_forward_launch_raises_and_is_not_counted(fake_card, rc,
                                                          match):
    fake_card(_FakeLibrary(rc))
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(9, d=64))
    before = (_build.COUNTS["flash_attentions"],
              _build.COUNTS["flash_attention_bwds"])
    with pytest.raises(RuntimeError, match=match):
        fa.flash_attention_bshd(q, k, v)
    if rc == 700:
        with pytest.raises(RuntimeError, match="flash_attention_bwd kernel "
                           "launch failed: cudaError 700"):
            fa.flash_attention_bwd(q, k, v, q, do, torch.zeros(B, H, S))
    assert (_build.COUNTS["flash_attentions"],
            _build.COUNTS["flash_attention_bwds"]) == before


@pytest.mark.parametrize("how", ["backward_of_vmap", "grad_of_vmap"])
def test_vmap_rule_refuses_autograd_from_outside_the_vmap(how):
    """The vmap rules run the forward itself, which autograd cannot see
    through: a gradient asked from outside the vmap raises instead of
    coming out short (``vmap(grad)`` is held above)."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(3, B, S, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(3, B, S, KH, D)).astype(np.float32))

    def f(q, k):
        return torch.sum(ops.gqa_flash_attention(q, k, k) ** 2)

    with torch.no_grad():
        torch.func.vmap(f)(q.clone().requires_grad_(), k)
    with pytest.raises(RuntimeError, match="vmap"):
        if how == "backward_of_vmap":
            torch.func.vmap(f)(q.clone().requires_grad_(), k).sum().backward()
        else:
            torch.func.grad(lambda q: torch.func.vmap(f)(q, k).sum())(q)
