"""The port's flash attention against the JAX reference: the plain version
(``repro_torch.kernels.flash_attention.flash_attention_plain``) against
``repro.kernels.ref.flash_attention`` and against the interpreted Pallas
kernel, ``ops.gqa_flash_attention`` against the reference wrapper, and the
model's attention (``naive`` and ``blocked`` on the CPU) against its JAX
twin.

On the CPU the kernel wrapper runs the plain version; the CUDA kernel is held
against the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 10).

Tolerances: the reference's own (``tests/test_kernels.py``), on inputs
scaled by 0.5 -- 2e-5 in float32 (summation order) and 3e-2 in bfloat16
(the logits rounded to bfloat16 by the ``einsum``, the probabilities cast to
bfloat16 before the PV product: both packages round there, but their
bfloat16 products round differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch import interop
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _inputs(shape, seed, jdt, tdt, n=3):
    rng = np.random.default_rng(seed)
    arrs = [(rng.normal(size=shape) * 0.5).astype(np.float32)
            for _ in range(n)]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, exp, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("s,d", [(128, 64), (256, 128), (512, 64)])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_plain_matches_ref_causal(s, d, name, jdt, tdt):
    (q, k, v), (tq, tk, tv) = _inputs((2, 3, s, d), 1, jdt, tdt)
    exp = ref.flash_attention(q, k, v, causal=True)
    got = fa.flash_attention_plain(tq, tk, tv, causal=True)
    assert got.dtype == tdt
    _close(got, exp, TOL[name])


@pytest.mark.parametrize("s,d,bq,bk", [(128, 64, 64, 64),
                                       (256, 128, 128, 128),
                                       (512, 64, 128, 64)])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_plain_matches_interpreted_pallas(s, d, bq, bk, name, jdt, tdt):
    (q, k, v), (tq, tk, tv) = _inputs((2, 3, s, d), 1, jdt, tdt)
    exp = pallas_flash(q, k, v, causal=True, bq=bq, bk=bk, interpret=True)
    got = fa.flash_attention_plain(tq, tk, tv, causal=True)
    _close(got, exp, TOL[name])


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_plain_window_softcap(window, softcap):
    (q, k, v), (tq, tk, tv) = _inputs((1, 2, 256, 64), 2, jnp.float32,
                                      torch.float32)
    got = fa.flash_attention_plain(tq, tk, tv, causal=True, window=window,
                                   softcap=softcap)
    exp_ref = ref.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=softcap)
    exp_pallas = pallas_flash(q, k, v, causal=True, window=window,
                              softcap=softcap, bq=64, bk=64, interpret=True)
    _close(got, exp_ref, 3e-5)
    _close(got, exp_pallas, 3e-5)


def test_plain_not_causal_ignores_window():
    """Without causal, ``ref.flash_attention`` (and the port) apply no
    window; the Pallas kernel would (ROADMAP Queue 3)."""
    (q, k, v), (tq, tk, tv) = _inputs((1, 2, 128, 64), 4, jnp.float32,
                                      torch.float32)
    got = fa.flash_attention_plain(tq, tk, tv, causal=False, window=32)
    _close(got, ref.flash_attention(q, k, v, causal=False, window=32), 2e-5)
    _close(got, ref.flash_attention(q, k, v, causal=False), 2e-5)


@pytest.mark.parametrize("s,h,kh,d,window,softcap", [
    (128, 8, 2, 64, None, None),       # test_kernels.py's GQA case
    (128, 4, 2, 32, 48, 50.0),         # gemma2 smoke: window + softcap
    (100, 4, 4, 64, None, None),       # ragged S, no GQA
])
def test_gqa_wrapper_matches_reference_wrapper(s, h, kh, d, window, softcap):
    rng = np.random.default_rng(3)
    arrs = [(rng.normal(size=(2, s, n, d)) * 0.3).astype(np.float32)
            for n in (h, kh, kh)]
    exp = jops.gqa_flash_attention(*map(jnp.asarray, arrs), causal=True,
                                   window=window, softcap=softcap,
                                   interpret=True)
    before = _build.COUNTS["flash_attentions"]
    got = ops.gqa_flash_attention(*map(torch.from_numpy, arrs), causal=True,
                                  window=window, softcap=softcap)
    assert _build.COUNTS["flash_attentions"] == before  # CPU: plain version
    assert got.shape == (2, s, h, d)
    _close(got, exp, 3e-5)


@pytest.mark.parametrize("impl", ["naive", "blocked"])
@pytest.mark.parametrize("window,softcap", [(None, None), (48, 50.0)])
def test_attention_train_matches_reference(impl, window, softcap):
    """The model's full-sequence GQA attention on the CPU, each formulation
    against its JAX twin (weights carried across from the reference)."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L

    jcfg = JL.AttnCfg(num_heads=4, num_kv_heads=2, head_dim=32,
                      window=window, logit_softcap=softcap, impl=impl,
                      block_q=32)
    cfg = L.AttnCfg(num_heads=4, num_kv_heads=2, head_dim=32, window=window,
                    logit_softcap=softcap, impl=impl, block_q=32)
    p, _ = JL.init_attention(jax.random.PRNGKey(0), jcfg, 64, jnp.float32)
    x = np.random.default_rng(5).normal(size=(2, 96, 64)).astype(np.float32)
    pos = np.arange(96)[None]
    exp = JL.attention_train(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = L.attention_train(interop.params_to_torch(p, "cpu"), cfg,
                            torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, exp, 1e-5)


def test_kernel_layout_checks():
    """What the kernel refuses raises before any launch (checked here on
    CPU tensors; the checks do not look at the device)."""
    q = torch.zeros(1, 8, 4, 64)
    fa._check_kernel_layout(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="dtype"):
        fa._check_kernel_layout(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="head dim"):
        w = torch.zeros(1, 8, 4, 40)
        fa._check_kernel_layout(w, w, w)
    with pytest.raises(ValueError, match="contiguous head dim"):
        t = torch.zeros(1, 8, 64, 4).transpose(2, 3)
        fa._check_kernel_layout(t, t, t)
    with pytest.raises(ValueError, match="kv heads"):
        fa.flash_attention_bshd(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match="different dtypes"):
        fa.flash_attention_bshd(q, q.half(), q)
    m = q.to("meta")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        fa.flash_attention_bshd(m, m, m)


# -- what surrounds the tensor-core kernel ------------------------------------

def _admitted(s, causal, window):
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    if not causal:
        return np.ones((s, s), bool)
    ok = j <= i
    if window is not None:
        ok &= j > i - window
    return ok


@pytest.mark.parametrize("bq,bk", sorted(
    {(128, 80), (128, 128), (64, 80), (64, 128), (128, 64)}
    | {fa.f32_tiles(d) for d in fa.HEAD_DIMS}))
@pytest.mark.parametrize("causal", [True, False])
def test_tile_plan_covers_every_admitted_pair(bq, bk, causal):
    """Against a brute-force mask: every admitted pair lies in a visited
    tile, a tile is masked exactly when it holds a refused pair, every block
    visits a tile, and a warpgroup's tiles lie in its block's (the producer
    loads the block's tiles), the others masked whole for it."""
    for s in (1, 17, 63, 64, 65, 127, 128, 129, 200, 1000):
        for window in (None, 1, 33, bk - 1, bk, bk + 1, 500, s, s + 7):
            ok = _admitted(s, causal, window)
            plan = fa.tile_plan(s, causal=causal, window=window, bq=bq, bk=bk)
            assert [q0 for q0, *_ in plan] == list(range(0, s, bq))
            for q0, t0, t1, masked in plan:
                rows = ok[q0:q0 + bq]
                assert 0 <= t0 < t1 <= -(-s // bk), (s, window, q0)
                keys = np.nonzero(rows.any(axis=0))[0]
                assert keys.size and t0 <= keys[0] // bk \
                    and keys[-1] // bk < t1, (s, window, q0)
                assert len(masked) == t1 - t0
                for t, m in zip(range(t0, t1), masked):
                    tile = rows[:, t * bk:(t + 1) * bk]
                    full = tile.shape[1] == bk and tile.all()
                    assert m == (not full), (s, window, q0, t)
                if bq == fa.BLOCK_Q:
                    for w in range(2):
                        qw = q0 + w * fa.WARPGROUP_Q
                        if qw >= s:
                            continue
                        w0, w1 = fa.kv_tile_range(
                            s, qw, fa.WARPGROUP_Q, bk, causal=causal,
                            window=window if causal else None)
                        assert t0 <= w0 < w1 <= t1, (s, window, q0, w)
                        for t in [*range(t0, w0), *range(w1, t1)]:
                            assert fa.tile_masked(
                                s, qw, fa.WARPGROUP_Q, t * bk, bk,
                                causal=causal,
                                window=window if causal else None)
                            assert not ok[qw:qw + fa.WARPGROUP_Q,
                                          t * bk:(t + 1) * bk].any()


def test_tile_plan_skips_masks_on_full_tiles():
    """gemma2's prefill shape: of the 4,608-token causal plan at the
    kernel's D = 256 tiles, only the tiles on a block's diagonal (at most
    3 of 80 keys across 128 rows) and the ragged last one take the
    per-element mask; with the 4,096 window, also those on its lower
    edge."""
    bk = fa.block_k(256)
    plan = fa.tile_plan(4608, causal=True, bq=fa.BLOCK_Q, bk=bk)
    n_tiles = sum(t1 - t0 for _, t0, t1, _ in plan)
    per_block = [sum(m) for *_, m in plan]
    assert max(per_block) <= 3 and min(per_block) >= 1
    assert sum(per_block) < 0.1 * n_tiles
    local = fa.tile_plan(4608, causal=True, window=4096, bq=fa.BLOCK_Q,
                         bk=bk)
    assert sum(t1 - t0 for _, t0, t1, _ in local) < n_tiles
    assert max(sum(m) for *_, m in local) <= 6
    assert sum(sum(m) for *_, m in local) > sum(per_block)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_warpgroup_plan_against_brute_force(d, causal):
    """The plan the compiled kernel must report (``kernel_tile_plan`` is
    held to it on the card): ``tile_plan``'s block ranges at the kernel's
    tile sizes, and per tile a warpgroup masks exactly when the tile holds a
    refused pair for its rows below S."""
    bk = fa.block_k(d)
    for s in (1, 65, 129, bk + 1, 700):
        for window in (None, 1, bk, 300):
            ok = _admitted(s, causal, window)
            sizes, plan = fa.warpgroup_plan(s, d, causal=causal,
                                            window=window)
            assert sizes == (fa.BLOCK_Q, fa.WARPGROUP_Q, bk)
            ranges = fa.tile_plan(s, causal=causal, window=window,
                                  bq=fa.BLOCK_Q, bk=bk)
            assert [p[:3] for p in plan] == [r[:3] for r in ranges]
            for q0, t0, t1, masks in plan:
                assert len(masks) == t1 - t0
                for t, pair in zip(range(t0, t1), masks):
                    for w, m in enumerate(pair):
                        qw = q0 + w * fa.WARPGROUP_Q
                        if qw >= s:
                            continue  # no rows: nothing of it is written
                        tile = ok[qw:qw + fa.WARPGROUP_Q,
                                  t * bk:(t + 1) * bk]
                        full = tile.shape[1] == bk and tile.all()
                        assert m == (not full), (s, window, q0, t, w)


def _kernel_softcap(x, cap):
    """The kernel's softcap in float32: cap * (1 - 2 / (1 + 2^(2 y log2 e)))
    with y = x / cap (csrc/flash_attention.cu: softmax_tile, there in base-2
    units; ex2 and rcp as exact float32 operations here)."""
    f = np.float32
    x = np.asarray(x, f)
    e = np.exp2(x * f(2 * np.log2(np.e) / cap))
    return f(cap) * (f(1) - f(2) / (f(1) + e))


@pytest.mark.parametrize("cap", [20.0, 30.0, 50.0])
def test_kernel_softcap_formula_matches_tanh(cap):
    """Within 1e-3 of cap * tanh(x / cap) in absolute terms over
    |x| <= 8 cap -- a tenth of the bfloat16 row tolerance, since a logit off
    by d scales its probability by about 1 + d -- and finite, within
    [-cap, cap], far beyond."""
    x = np.linspace(-8 * cap, 8 * cap, 400_001)
    with np.errstate(over="ignore"):
        got = _kernel_softcap(x, cap).astype(np.float64)
        far = _kernel_softcap(np.array([-1e30, -1e6, 1e6, 1e30]), cap)
    exp = cap * np.tanh(x.astype(np.float32).astype(np.float64) / cap)
    assert np.abs(got - exp).max() <= 1e-3
    assert np.isfinite(far).all() and (np.abs(far) <= cap).all()
    np.testing.assert_allclose(far, [-cap, -cap, cap, cap])
