"""Model layers: the dense-GQA part of :mod:`repro.models.layers`.

What the serving path of the dense attention models (gemma2, stablelm,
mistral-nemo) runs: init helpers, RMS norm, rotary embedding, softcap, the
gated MLPs, and GQA attention with an optional sliding window and tanh
logit softcap -- full-sequence (prefill) and one token against a linear or
ring-buffer KV cache (decode).

Every ``init_*`` returns the params alone (the reference's logical-axis
specs serve its sharding, which one card does not need); the draws come
from an explicit ``torch.Generator`` (on the device the params are made on)
at the reference's scales, so they differ from ``jax.random``'s: the tests
carry the reference's params across through :mod:`repro_torch.interop`.

Full-sequence attention on CUDA tensors always goes through the flash
kernel (``kernels/ops.gqa_flash_attention``); on CPU tensors it keeps the
reference's ``impl`` switch (``naive``: :func:`_sdpa`, ``blocked``:
:func:`_blocked_sdpa`), so each formulation is held against its JAX twin.

Decode writes the new token's K/V into the cache buffers in place
(:func:`_write_slot`) instead of returning fresh copies: a functional copy
of a multi-GB cache per token would cost more than the decode.

MLA, MoE, RG-LRU, Mamba2 and the encoder/VLM front ends are not ported
yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet")


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, scale, dtype):
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(scale).to(dtype)


def init_dense(gen, shape, dtype, scale=None):
    """A weight tensor with fan-in scaling over the leading dim(s)."""
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return _normal(gen, shape, scale, dtype)


def init_embed(gen, vocab, d, dtype):
    return _normal(gen, (vocab, d), 0.02, dtype)


def init_norm(d, dtype, device=None):
    return torch.ones((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# basic ops
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope(x, positions, theta=10000.0):
    """Rotary embedding.  x: (..., seq, heads, head_dim); positions:
    (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap):
    return cap * torch.tanh(x / cap)


def swiglu(gate, up):
    return F.silu(gate) * up


def gelu_mul(gate, up):
    return F.gelu(gate, approximate="tanh") * up


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    kind: str = "gqa"  # gqa | mla (not ported)
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding window size (None = full)
    logit_softcap: Optional[float] = None
    causal: bool = True
    # CPU formulation (set from ArchConfig by transformer._mixer_cfg); CUDA
    # tensors always take the flash kernel
    impl: str = "naive"  # naive (S^2 logits) | blocked (query-block loop)
    block_q: int = 512


def init_attention(gen, cfg: AttnCfg, d_model: int, dtype):
    if cfg.kind != "gqa":
        raise _not_ported(f"{cfg.kind!r} attention")
    hd, h, kh = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    return {"wq": init_dense(gen, (d_model, h, hd), dtype),
            "wk": init_dense(gen, (d_model, kh, hd), dtype),
            "wv": init_dense(gen, (d_model, kh, hd), dtype),
            "wo": init_dense(gen, (h, hd, d_model), dtype)}


def _masked(logits, mask):
    return torch.where(mask, logits, torch.full((), NEG_INF,
                                                device=logits.device))


def _sdpa(q, k, v, mask, scale, cap=None):
    """q: (B,S,H,Dk)  k: (B,T,K,Dk)  v: (B,T,K,Dv) with H = K*rep.
    mask: broadcastable to (B,K,rep,S,T) or None."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    dv = v.shape[-1]
    rep = h // kh
    qg = q.reshape(b, sq, kh, rep, d)
    logits = torch.einsum("bskrd,btkd->bkrst", qg, k).float() * scale
    if cap is not None:
        logits = softcap(logits, cap)
    if mask is not None:
        logits = _masked(logits, mask[:, None, None, :, :] if mask.ndim == 3
                         else mask)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", probs, v)
    return out.reshape(b, sq, h, dv)


def _blocked_sdpa(q, k, v, *, causal, window, cap, scale, block_q):
    """The reference's flash-style formulation: a loop over query blocks,
    so only a (Bq, T) logits tile is live at a time (the reference's
    ``lax.scan`` over blocks).

    q: (B,S,H,Dk)  k: (B,T,K,Dk)  v: (B,T,K,Dv).  Returns (B,S,H,Dv).
    """
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = h // kh
    bq = min(block_q, s)
    while s % bq:
        bq //= 2
    kpos = torch.arange(t, device=q.device)
    outs = []
    for i in range(s // bq):
        qb = q[:, i * bq:(i + 1) * bq].reshape(b, bq, kh, rep, d)
        logits = torch.einsum("bskrd,btkd->bkrst", qb, k).float() * scale
        if cap is not None:
            logits = softcap(logits, cap)
        if causal:
            qpos = i * bq + torch.arange(bq, device=q.device)
            m = kpos[None, :] <= qpos[:, None]
            if window is not None:
                m &= kpos[None, :] > qpos[:, None] - window
            logits = _masked(logits, m)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkrst,btkd->bskrd", probs, v))
    return torch.cat(outs, dim=1).reshape(b, s, h, dv)


def causal_mask(sq, st, q_offset=0, window=None, device=None):
    """(sq, st) boolean mask; True = attend.  q position i attends kv j iff
    j <= i + q_offset and (window is None or j > i + q_offset - window)."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(st, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def _qkv(p, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return q, k, v


def attention_train(p, cfg: AttnCfg, x, positions):
    """Full-sequence attention (training / prefill compute path)."""
    if cfg.kind != "gqa":
        raise _not_ported(f"{cfg.kind!r} attention")
    q, k, v = _qkv(p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    sq = x.shape[1]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if x.device.type == "cuda":
        out = ops.gqa_flash_attention(q, k, v, causal=cfg.causal,
                                      window=cfg.window,
                                      softcap=cfg.logit_softcap)
    elif cfg.impl == "blocked":
        out = _blocked_sdpa(q, k, v, causal=cfg.causal, window=cfg.window,
                            cap=cfg.logit_softcap, scale=scale,
                            block_q=cfg.block_q)
    else:
        mask = (causal_mask(sq, sq, window=cfg.window,
                            device=x.device)[None, None]
                if cfg.causal else None)
        out = _sdpa(q, k, v, mask, scale, cfg.logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# --- decode path (one new token against a cache) ---------------------------


def attention_decode(p, cfg: AttnCfg, x, cache, cache_len):
    """x: (B,1,d); cache dict with ring-or-linear k/v buffers.

    Returns (out (B,1,d), cache).  The cache buffer length T is either the
    max sequence (linear) or the sliding window (ring); ``cache_len`` is the
    number of tokens already written (the new token's position) -- a 0-d
    tensor shared by the whole batch, or a ``(B,)`` tensor of per-slot
    lengths (continuous batching).  The new token's K/V are written into
    ``cache``'s buffers in place; the returned dict holds those buffers.
    """
    if cfg.kind != "gqa":
        raise _not_ported(f"{cfg.kind!r} attention")
    pos = cache_len[..., None]  # (B,1) or (1,)
    q, k_new, v_new = _qkv(p, x)
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    T = cache["k"].shape[1]
    slot = cache_len % T
    k_buf = _write_slot(cache["k"], k_new, slot)
    v_buf = _write_slot(cache["v"], v_new, slot)
    # valid positions: absolute kv index of each buffer slot; a vector
    # cache_len gives a per-row (B,T) mask
    idx = torch.arange(T, device=x.device)
    cl = cache_len[..., None] if cache_len.ndim else cache_len
    if cfg.window is not None and T == cfg.window:
        # ring buffer: slot j holds absolute position p where p % T == j and
        # p <= cache_len; valid iff cache_len - T < p_abs <= cache_len
        p_abs = cl - ((cl - idx) % T)
        valid = (p_abs >= 0) & (p_abs >= cl - T + 1)
    else:
        valid = idx <= cl
    if cache_len.ndim:
        mask = valid[:, None, None, None, :]  # (B,1,1,1,T)
    else:
        mask = valid[None, None, None, None, :]  # (1,1,1,1,T)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    out = _sdpa_masked_flat(q, k_buf, v_buf, mask, scale, cfg.logit_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, {"k": k_buf, "v": v_buf}


def _write_slot(buf, new, slot):
    """buf: (B,T,...); new: (B,1,...); write new at index ``slot`` along
    axis 1, in place, and return ``buf``.  ``slot`` is a 0-d tensor (the
    whole batch writes one column) or a ``(B,)`` tensor (each row writes
    its own column).  No host sync either way."""
    new = new.to(buf.dtype)
    if slot.ndim:
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, slot.long()] = new[:, 0]
    else:
        buf.index_copy_(1, slot.long().reshape(1), new)
    return buf


def _sdpa_masked_flat(q, k, v, mask, scale, cap=None):
    b, sq, h, d = q.shape
    kh = k.shape[2]
    dv = v.shape[-1]
    rep = h // kh
    qg = q.reshape(b, sq, kh, rep, d)
    logits = torch.einsum("bskrd,btkd->bkrst", qg, k).float() * scale
    if cap is not None:
        logits = softcap(logits, cap)
    logits = _masked(logits, mask)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", probs, v)
    return out.reshape(b, sq, h, dv)


def init_attn_cache(cfg: AttnCfg, batch, max_len, dtype, device=None,
                    lead=()):
    """Zeroed k/v cache buffers for one attention layer, ``(*lead, batch,
    T, kv_heads, head_dim)`` with T the window for a sliding window (a ring
    buffer) and ``max_len`` otherwise."""
    if cfg.kind != "gqa":
        raise _not_ported(f"{cfg.kind!r} attention cache")
    T = min(max_len, cfg.window) if cfg.window is not None else max_len
    shape = tuple(lead) + (batch, T, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model, d_ff, dtype):
    return {"w_gate": init_dense(gen, (d_model, d_ff), dtype),
            "w_up": init_dense(gen, (d_model, d_ff), dtype),
            "w_down": init_dense(gen, (d_ff, d_model), dtype)}


def mlp(p, x, act="swiglu"):
    actfn = swiglu if act == "swiglu" else gelu_mul
    h = actfn(x @ p["w_gate"], x @ p["w_up"])
    return h @ p["w_down"]
