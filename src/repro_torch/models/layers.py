"""Model layers: the port of :mod:`repro.models.layers`.

What the ten architectures run: init helpers, RMS norm, rotary embedding,
softcap, the gated MLPs, GQA attention with an optional sliding window,
tanh logit softcap and a bidirectional (not causal) mode -- full-sequence
(prefill) and one token against a linear or ring-buffer KV cache (decode)
-- MLA latent attention (deepseek-v3: materialised for the full sequence,
absorbed against the latent cache for decode), the capacity-based top-k
MoE block with an optional shared expert, the RG-LRU recurrent block
(Griffin) and the Mamba2 SSD block, each full-sequence and one token
against its state cache.

Every ``init_*`` returns the params alone (the reference's logical-axis
specs serve its sharding, which one card does not need); the draws come
from an explicit ``torch.Generator`` (on the device the params are made on)
at the reference's scales, so they differ from ``jax.random``'s: the tests
carry the reference's params across through :mod:`repro_torch.interop`.

Full-sequence attention on CUDA tensors always goes through the flash
kernel (``kernels/ops.gqa_flash_attention``), MLA's too (Dk 192 against Dv
128 at full width: the wrapper pads both to the kernel's 256); on CPU
tensors it keeps the reference's ``impl`` switch (``naive``: :func:`_sdpa`,
``blocked``: :func:`_blocked_sdpa`), so each formulation is held against
its JAX twin.

Decode writes the new token's K/V (MLA: its latent and rope key) into the
cache buffers in place (:func:`_write_slot`) instead of returning fresh
copies: a functional copy of a multi-GB cache per token would cost more
than the decode.

The MoE's dispatch and combine are plain PyTorch, as the reference's are
``jnp`` (no Pallas kernel), with a static capacity and no data-dependent
shape or host sync, so ``torch.func.vmap`` over ``grad_and_value``
composes.  The combine adds each token's K expert outputs in order k = 0..K-1
from zero with no atomics: the reference's scatter-add order, bitwise on
the CPU and deterministic on the card.  The expert products are
``torch.einsum`` (batched matmuls), as the reference's.

The RG-LRU and SSD recurrences are ``jnp`` in the reference (no Pallas
kernel) and plain PyTorch on tensors here, on the card too: the linear
recurrence h_t = a_t h_{t-1} + b_t is a log-depth doubling scan
(:func:`_linear_scan`, ~log2 S elementwise passes, never a Python loop
over S), out of place so that ``torch.func.vmap`` and ``grad`` (the
trainer's per-client gradient) compose.  It associates its products in
another order than XLA's ``associative_scan``, so it agrees with the
reference to float32 rounding, not bitwise.  ``F.softplus`` returns x
above 20 where ``jax.nn.softplus`` is ``logaddexp(x, 0)``; the two differ
there by at most log1p(exp(-20)) ~ 2.1e-9, below float32's spacing at 20
(1.9e-6), so they round alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import gemm, ops

NEG_INF = -1e30


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
    kind: str = "gqa"  # gqa | mla
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding window size (None = full)
    logit_softcap: Optional[float] = None
    causal: bool = True
    # MLA only:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    # CPU formulation (set from ArchConfig by transformer._mixer_cfg); CUDA
    # tensors always take the flash kernel
    impl: str = "naive"  # naive (S^2 logits) | blocked (query-block loop)
    block_q: int = 512


def init_attention(gen, cfg: AttnCfg, d_model: int, dtype):
    h = cfg.num_heads
    if cfg.kind == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        r = cfg.kv_lora_rank
        return {"wq": init_dense(gen, (d_model, h, qk), dtype),
                "w_dkv": init_dense(gen, (d_model, r + cfg.qk_rope_dim),
                                    dtype),
                "w_uk": init_dense(gen, (r, h, cfg.qk_nope_dim), dtype),
                "w_uv": init_dense(gen, (r, h, cfg.v_dim), dtype),
                "wo": init_dense(gen, (h, cfg.v_dim, d_model), dtype)}
    if cfg.kind != "gqa":
        raise ValueError(cfg.kind)
    hd, kh = cfg.head_dim, cfg.num_kv_heads
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


# the fewest rows (tokens) a product takes to the split-TF32 kernel: its
# tiles are 128 rows, so below one tile (a decode step's batch, a short
# prompt) it does a whole tile's work and cuBLAS's float32 product is as
# fast or faster
KERNEL_MIN_ROWS = 128


def _on_kernel(x, ws, rows: int) -> bool:
    """Whether ``rows`` rows of ``x`` times the weights ``ws`` go to the
    split-TF32 kernel: float32 operands on a CUDA device, at least
    :data:`KERNEL_MIN_ROWS` rows."""
    return (x.device.type == "cuda" and x.dtype == torch.float32
            and all(w.dtype == torch.float32 for w in ws)
            and rows >= KERNEL_MIN_ROWS)


def _dense(x, ws, contract, plain):
    """The products of ``x``'s last ``contract`` axes with the first
    ``contract`` axes of each of the weights ``ws`` (``x`` (..., K...) times
    ``w`` (K..., N...) -> (..., N...)), a tuple, routed by what it
    observes (:func:`_on_kernel`, ``x``'s leading axes the rows): to the
    split-TF32 kernel (:func:`repro_torch.kernels.gemm.matmuls`, ``x`` and
    each ``w`` as (M, K) and (K, N) views, one autograd Function for the
    weights that share ``x``); anything else (bf16 / f16, the CPU, a
    decode step's few rows) is ``plain()``, the expressions the call site
    has always used."""
    lead = x.shape[:x.ndim - contract]
    if not _on_kernel(x, ws, math.prod(lead)):
        return plain()
    ys = gemm.matmuls(x.reshape(*lead, -1),
                      *(w.reshape(-1, math.prod(w.shape[contract:]))
                        for w in ws))
    return tuple(y.reshape(*lead, *w.shape[contract:]) for y, w in zip(ys, ws))


def _qkv(p, x):
    ws = (p["wq"], p["wk"], p["wv"])
    return _dense(x, ws, 1, lambda: tuple(
        torch.einsum("bsd,dhk->bshk", x, w) for w in ws))


def _attend(cfg: AttnCfg, q, k, v, causal: bool, scale: float):
    """Full-sequence attention of q (B,S,H,Dk) over k (B,S,K,Dk), v
    (B,S,K,Dv): the flash kernel on CUDA tensors (its scale is
    ``1/sqrt(Dk)``, which is ``scale`` for every caller), else the
    reference's ``impl``."""
    if q.device.type == "cuda":
        return ops.gqa_flash_attention(q, k, v, causal=causal,
                                       window=cfg.window,
                                       softcap=cfg.logit_softcap)
    if cfg.impl == "blocked":
        return _blocked_sdpa(q, k, v, causal=causal, window=cfg.window,
                             cap=cfg.logit_softcap, scale=scale,
                             block_q=cfg.block_q)
    sq = q.shape[1]
    mask = (causal_mask(sq, sq, window=cfg.window,
                        device=q.device)[None, None] if causal else None)
    return _sdpa(q, k, v, mask, scale, cfg.logit_softcap)


def attention_train(p, cfg: AttnCfg, x, positions):
    """Full-sequence attention (training / prefill compute path)."""
    if cfg.kind == "mla":
        return _mla_train(p, cfg, x, positions)
    q, k, v = _qkv(p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = _attend(cfg, q, k, v, cfg.causal, 1.0 / math.sqrt(cfg.head_dim))
    return _dense(out, (p["wo"],), 2, lambda: (
        torch.einsum("bshk,hkd->bsd", out, p["wo"]),))[0]


def _mla_latent(p, cfg: AttnCfg, x, positions):
    """The latent ``ckv`` (B,S,r) and the rotated rope key (B,S,1,rope) of
    ``x``: what MLA's cache holds."""
    dkv = x @ p["w_dkv"]
    r = cfg.kv_lora_rank
    ckv, k_rope = dkv[..., :r], dkv[..., r:]
    return ckv, rope(k_rope[:, :, None, :], positions, cfg.rope_theta)


def _mla_query(p, cfg: AttnCfg, x, positions):
    """(q_nope (B,S,H,nope), rotated q_rope (B,S,H,rope))."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_train(p, cfg: AttnCfg, x, positions):
    """MLA in the materialised (training / prefill) form: keys and values
    up-projected from the latent for every head, always causal, as the
    reference's."""
    q_nope, q_rope = _mla_query(p, cfg, x, positions)
    ckv, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", ckv, p["w_uv"])
    h = cfg.num_heads
    k = torch.cat([k_nope, k_rope.expand(k_rope.shape[0], k_rope.shape[1], h,
                                         cfg.qk_rope_dim)], dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    out = _attend(cfg, qfull, k, v, True, scale)
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
    if cfg.kind == "mla":
        return _mla_decode(p, cfg, x, cache, cache_len)
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


def _mla_decode(p, cfg: AttnCfg, x, cache, cache_len):
    """Absorbed MLA decode: the cache holds the latent and the rope key
    only; the key up-projection is absorbed into the query and the value
    up-projection applied after the softmax, as the reference's.  Writes
    the new token's latent and rope key in place; returns (out, cache)."""
    pos = cache_len[..., None]
    q_nope, q_rope = _mla_query(p, cfg, x, pos)
    ckv_new, krope_new = _mla_latent(p, cfg, x, pos)
    T = cache["ckv"].shape[1]
    slot = cache_len % T
    ckv = _write_slot(cache["ckv"], ckv_new, slot)
    krope = _write_slot(cache["k_rope"], krope_new[:, :, 0, :], slot)
    # absorb k_up into the query: (B,1,H,nope) x (r,H,nope) -> (B,1,H,r)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    logits = (torch.einsum("bshr,btr->bhst", q_lat, ckv)
              + torch.einsum("bshk,btk->bhst", q_rope, krope)).float()
    logits = logits * (1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim))
    if cfg.logit_softcap is not None:
        logits = softcap(logits, cfg.logit_softcap)
    idx = torch.arange(T, device=x.device)
    if cache_len.ndim:  # per-slot lengths: (B,T) mask over (B,H,S,T)
        valid = (idx[None, :] <= cache_len[:, None])[:, None, None, :]
    else:
        valid = (idx <= cache_len)[None, None, None, :]
    probs = torch.softmax(_masked(logits, valid), dim=-1).to(ckv.dtype)
    out_lat = torch.einsum("bhst,btr->bshr", probs, ckv)  # (B,1,H,r)
    out = torch.einsum("bshr,rhk->bshk", out_lat, p["w_uv"])  # (B,1,H,v)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, {"ckv": ckv, "k_rope": krope}


def init_attn_cache(cfg: AttnCfg, batch, max_len, dtype, device=None,
                    lead=()):
    """Zeroed cache buffers for one attention layer: k/v ``(*lead, batch,
    T, kv_heads, head_dim)``, or for MLA the latent ``ckv`` ``(*lead,
    batch, T, kv_lora_rank)`` and ``k_rope`` ``(*lead, batch, T,
    qk_rope_dim)``; T is the window for a sliding window (a ring buffer)
    and ``max_len`` otherwise."""
    T = min(max_len, cfg.window) if cfg.window is not None else max_len
    lead = tuple(lead)
    if cfg.kind == "mla":
        return {"ckv": torch.zeros(lead + (batch, T, cfg.kv_lora_rank),
                                   dtype=dtype, device=device),
                "k_rope": torch.zeros(lead + (batch, T, cfg.qk_rope_dim),
                                      dtype=dtype, device=device)}
    shape = lead + (batch, T, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLPs and MoE
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model, d_ff, dtype):
    return {"w_gate": init_dense(gen, (d_model, d_ff), dtype),
            "w_up": init_dense(gen, (d_model, d_ff), dtype),
            "w_down": init_dense(gen, (d_ff, d_model), dtype)}


def mlp(p, x, act="swiglu"):
    """The gated MLP; on the split-TF32 kernel (:func:`_on_kernel`) its
    three products and activation are one autograd Function
    (:func:`repro_torch.kernels.gemm.mlp`: one Function call fewer a layer
    than two :func:`_dense` calls, for the host's sake under
    ``vmap(grad)``)."""
    actfn = swiglu if act == "swiglu" else gelu_mul
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if _on_kernel(x, (wg, wu, wd), math.prod(x.shape[:-1])):
        return gemm.mlp(x, wg, wu, wd, actfn)
    h = actfn(x @ wg, x @ wu)
    return h @ wd


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 1024
    num_shared: int = 0          # deepseek-v3 style shared expert(s)
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0


def init_moe(gen, cfg: MoECfg, d_model, dtype):
    E, F_ = cfg.num_experts, cfg.d_ff_expert
    p = {"router": init_dense(gen, (d_model, E), dtype),
         "w_gate": init_dense(gen, (E, d_model, F_), dtype,
                              scale=1.0 / math.sqrt(d_model)),
         "w_up": init_dense(gen, (E, d_model, F_), dtype,
                            scale=1.0 / math.sqrt(d_model)),
         "w_down": init_dense(gen, (E, F_, d_model), dtype,
                              scale=1.0 / math.sqrt(F_))}
    if cfg.num_shared:
        p["shared"] = init_mlp(gen, d_model, cfg.d_ff_shared, dtype)
    return p


def moe_capacity(cfg: MoECfg, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: ``max(int(T K / E cf), 1)``,
    static."""
    return max(int(tokens * cfg.top_k / cfg.num_experts
                   * cfg.capacity_factor), 1)


def moe_route(p, cfg: MoECfg, xf):
    """The router over ``xf`` (T, d): (probs (T,E) float32, gates (T,K)
    renormalised over the top k, expert index (T,K))."""
    probs = torch.softmax((xf @ p["router"]).float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), expert_idx


def moe_dispatch(cfg: MoECfg, xf, expert_idx):
    """The dispatch: each (token, k) pair takes the next free slot of its
    expert's queue in token order, a pair past the capacity C is dropped,
    and each kept pair's row is added into its (expert, slot) --
    ``index_put`` with ``accumulate``, out of place: a slot holds one pair,
    the dropped ones add zeros to slot 0.  Returns (disp (E, C, d), flat
    expert index, slot, keep), the last three per pair (T*K,)."""
    T, d = xf.shape
    E, K = cfg.num_experts, cfg.top_k
    C = moe_capacity(cfg, T)
    flat_e = expert_idx.reshape(-1)  # (T*K,)
    onehot = (flat_e[:, None] == torch.arange(E, device=xf.device)).long()
    pos_in_e = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = (pos_in_e < C) & (pos_in_e >= 0)
    slot = torch.where(keep, pos_in_e, torch.zeros_like(pos_in_e))
    tok_idx = torch.arange(T, device=xf.device).repeat_interleave(K)
    contrib = torch.where(keep[:, None], xf[tok_idx],
                          torch.zeros((), dtype=xf.dtype, device=xf.device))
    disp = xf.new_zeros((E, C, d)).index_put((flat_e, slot), contrib,
                                             accumulate=True)
    return disp, flat_e, slot, keep


def moe_experts(p, disp, act="swiglu"):
    """Every expert's gated MLP over its (C, d) slots: batched matmuls."""
    actfn = swiglu if act == "swiglu" else gelu_mul
    h = actfn(torch.einsum("ecd,edf->ecf", disp, p["w_gate"]),
              torch.einsum("ecd,edf->ecf", disp, p["w_up"]))
    return torch.einsum("ecf,efd->ecd", h, p["w_down"])  # (E,C,d)


def moe_combine(eout, flat_e, slot, keep, gate_vals):
    """The combine: each (token, k) pair's slot output gathered back (0 for
    a dropped pair), weighted by its gate, and a token's K weighted outputs
    added in order k = 0..K-1 from zero.  Returns (T, d)."""
    T, K = gate_vals.shape
    gathered = torch.where(keep[:, None], eout[flat_e, slot],
                           torch.zeros((), dtype=eout.dtype,
                                       device=eout.device))
    w = gate_vals.reshape(-1)[:, None].to(gathered.dtype)
    weighted = (gathered * w).reshape(T, K, -1)
    out = torch.zeros_like(weighted[:, 0])
    for k in range(K):
        out = out + weighted[:, k]
    return out


def moe(p, cfg: MoECfg, x, act="swiglu"):
    """Capacity-based top-k MoE with scatter dispatch / gather combine, as
    the reference's: :func:`moe_route`, :func:`moe_dispatch`,
    :func:`moe_experts`, :func:`moe_combine`, plus the shared expert.
    Returns (out, aux_loss), aux_loss the load-balance loss ``E * sum_e
    frac_tokens_e * mean_router_prob_e``."""
    b, sq, d = x.shape
    xf = x.reshape(b * sq, d)
    probs, gate_vals, expert_idx = moe_route(p, cfg, xf)
    disp, flat_e, slot, keep = moe_dispatch(cfg, xf, expert_idx)
    eout = moe_experts(p, disp, act)
    out = moe_combine(eout, flat_e, slot, keep, gate_vals)
    out = out.reshape(b, sq, d).to(x.dtype)
    if cfg.num_shared:
        out = out + mlp(p["shared"], x, act)

    # load-balance auxiliary loss
    E = cfg.num_experts
    frac = (expert_idx[..., None] == torch.arange(E, device=x.device)
            ).float().sum(1).mean(0) / cfg.top_k
    aux = E * torch.sum(frac * probs.mean(0))
    return out, aux


# ---------------------------------------------------------------------------
# linear recurrences and the causal depthwise conv (RG-LRU, Mamba2)
# ---------------------------------------------------------------------------


def _linear_scan(a, b, dim: int = 1):
    """h_t = a_t * h_{t-1} + b_t along ``dim`` with h_{-1} = 0.

    A Hillis-Steele doubling scan: after the step of span s, element t
    holds (A, B) with h_t = A * h_{t-2s} + B, so ceil(log2 S) steps of a
    few elementwise passes finish it (12 at S = 4,096).  ``a`` may
    broadcast against ``b`` in every dim but ``dim``.  Out of place, with
    no data-dependent control flow, so ``vmap`` and ``grad`` compose.
    """
    n = b.shape[dim]
    span = 1
    while span < n:
        rest = n - span
        b = torch.cat([b.narrow(dim, 0, span),
                       b.narrow(dim, span, rest)
                       + a.narrow(dim, span, rest) * b.narrow(dim, 0, rest)],
                      dim)
        if 2 * span < n:  # the last step needs no products of a
            a = torch.cat([a.narrow(dim, 0, span),
                           a.narrow(dim, span, rest)
                           * a.narrow(dim, 0, rest)], dim)
        span *= 2
    return b


def _causal_conv1d(x, w, state=None):
    """x: (B,L,C); w: (W,C) depthwise.  state: (B,W-1,C) carry for decode.
    Returns (out, the last W-1 rows of the padded input).  The taps are
    summed in the order i = 0..W-1, in x's dtype, as the reference's."""
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1) + tuple(x.shape[2:]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, L+W-1, C)
    L_ = x.shape[1]
    out = sum(xp[:, i:i + L_] * w[i] for i in range(W))
    new_state = xp[:, xp.shape[1] - (W - 1):] if W > 1 else None
    return out, new_state


def conv_tail(u, W: int):
    """The conv state a decode step continues from after a prompt ``u``
    (B,S,C): its last W-1 rows, left-padded with zeros when S < W-1 (as
    the reference's ``_fill_rglru_cache``; its ``_fill_mamba2_cache``
    keeps ``u[:, -(W-1):]`` unpadded, which comes out short and makes the
    next decode step fail for such prompts)."""
    S = u.shape[1]
    tail = u[:, max(S - (W - 1), 0):]
    if S < W - 1:
        tail = torch.cat([u.new_zeros((u.shape[0], W - 1 - S)
                                      + tuple(u.shape[2:])), tail], dim=1)
    return tail


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RGLRUCfg:
    width: int = 0  # rnn width (defaults to d_model)
    conv_width: int = 4
    c: float = 8.0


def init_rglru_block(gen, cfg: RGLRUCfg, d_model, dtype):
    w = cfg.width or d_model
    p = {"w_x": init_dense(gen, (d_model, w), dtype),
         "w_gate": init_dense(gen, (d_model, w), dtype),
         "w_out": init_dense(gen, (w, d_model), dtype),
         "conv": _normal(gen, (cfg.conv_width, w), 0.1, dtype),
         "w_a": init_dense(gen, (w, w), dtype),
         "w_i": init_dense(gen, (w, w), dtype)}
    # Lambda init so that a = sigmoid(lam) in [0.9, 0.999]
    u = torch.rand((w,), generator=gen, dtype=torch.float32,
                   device=gen.device) * (0.999 - 0.9) + 0.9
    p["lam"] = torch.log(u / (1 - u))
    return p


def _rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t over axis 1 (:func:`_linear_scan`)."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return _linear_scan(a, b, dim=1)


def _rglru_coeffs(p, cfg: RGLRUCfg, u):
    """The recurrence's a_t and b_t (float32) from the conv output u."""
    r = torch.sigmoid((u @ p["w_a"]).float())
    i = torch.sigmoid((u @ p["w_i"]).float())
    log_a = -cfg.c * r * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a ** 2, min=1e-12)) * (i * u.float())
    return a, b


def rglru_block_train(p, cfg: RGLRUCfg, x, with_state: bool = False):
    """Full-sequence Griffin recurrent block.  ``with_state`` (prefill)
    also returns the conv's input (B,S,W) and the last state h_S (B,W)."""
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    u_in = x @ p["w_x"]
    u, _ = _causal_conv1d(u_in, p["conv"])
    a, b = _rglru_coeffs(p, cfg, u)
    h = _rglru_scan(a, b)
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return (out, u_in, h[:, -1]) if with_state else out


def rglru_block_decode(p, cfg: RGLRUCfg, x, cache):
    """One-token step. cache: {"h": (B,W) f32, "conv": (B,conv_w-1,W)},
    written in place; returns (out, cache)."""
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    u = x @ p["w_x"]
    u, conv_state = _causal_conv1d(u, p["conv"], cache["conv"])
    a, b = _rglru_coeffs(p, cfg, u)
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out, cache


def init_rglru_cache(cfg: RGLRUCfg, d_model, batch, dtype, device=None,
                     lead=()):
    w = cfg.width or d_model
    lead = tuple(lead)
    return {"h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, w),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality) layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    num_heads: int = 8      # H
    head_dim: int = 64      # P
    state_dim: int = 128    # N
    conv_width: int = 4
    chunk: int = 64
    expand: int = 2


def init_mamba2_block(gen, cfg: SSMCfg, d_model, dtype):
    H, P, N = cfg.num_heads, cfg.head_dim, cfg.state_dim
    inner = H * P
    dev = gen.device
    p = {"in_x": init_dense(gen, (d_model, inner), dtype),
         "in_z": init_dense(gen, (d_model, inner), dtype),
         "in_B": init_dense(gen, (d_model, N), dtype),
         "in_C": init_dense(gen, (d_model, N), dtype),
         "in_dt": init_dense(gen, (d_model, H), dtype),
         "conv": _normal(gen, (cfg.conv_width, inner + 2 * N), 0.1, dtype)}
    p["A_log"] = torch.log(torch.rand((H,), generator=gen,
                                      dtype=torch.float32, device=dev)
                           * 15.0 + 1.0)
    p["D"] = torch.ones((H,), dtype=torch.float32, device=dev)
    p["dt_bias"] = torch.zeros((H,), dtype=torch.float32, device=dev)
    p["out"] = init_dense(gen, (inner, d_model), dtype)
    return p


def _segsum(a):
    """a: (..., T). Returns (..., T, T) with out[..., i, j] = sum_{j<k<=i} a_k,
    -inf above the diagonal (strictly causal cumulative log-decay).  The
    -inf is a constant, so exp of it has a zero (finite) gradient."""
    T = a.shape[-1]
    cums = torch.cumsum(a, dim=-1)
    diff = cums[..., :, None] - cums[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full((), -math.inf,
                                              device=a.device))


def _pad_steps(t, pad):
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))],
                     dim=1)


def ssd_chunked(x, dt, A, B, C, D, chunk):
    """Chunked SSD forward; see :func:`ssd_chunked_with_state`."""
    return ssd_chunked_with_state(x, dt, A, B, C, D, chunk)[0]


def ssd_chunked_with_state(x, dt, A, B, C, D, chunk):
    """Chunked SSD forward (Mamba2, Dao & Gu 2024, Listing 1 adapted).

    x: (b,l,h,p)  dt: (b,l,h)  A: (h,) (negative)  B,C: (b,l,n)  D: (h,)
    Returns (y: (b,l,h,p), final_state: (b,h,p,n)).
    Sequences whose length is not a multiple of ``chunk`` are zero-padded:
    padded steps have dt=0 (decay exp(0)=1, zero input) so they neither decay
    nor perturb the state, and their outputs are discarded.  The reference's
    intra-chunk 5-operand einsum is two contractions here whose largest
    intermediate is (b, nc, h, q, q); the recurrence over chunks is
    :func:`_linear_scan`.
    """
    l_orig = x.shape[1]
    pad = (-l_orig) % chunk
    if pad:
        x, dt, B, C = (_pad_steps(t, pad) for t in (x, dt, B, C))
    b, l, h, p = x.shape
    n = B.shape[-1]
    q = chunk
    nc = l // q
    xb = (x * dt[..., None]).reshape(b, nc, q, h, p)
    a = (A[None, None] * dt).reshape(b, nc, q, h)  # log-decay per step
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)

    # intra-chunk (quadratic within chunk)
    Lm = torch.exp(_segsum(a.permute(0, 1, 3, 2)))  # (b,nc,h,q,q)
    G = torch.einsum("bcsn,bczn->bcsz", Cc, Bc)  # (b,nc,q,q)
    y_intra = torch.einsum("bchsz,bczhp->bcshp", G[:, :, None] * Lm, xb)

    # chunk states
    a_cum = torch.cumsum(a, dim=2)  # (b,nc,q,h)
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (b,nc,q,h)
    S = torch.einsum("bczn,bczhp->bchnp", Bc,
                     xb * decay_to_end[..., None])  # per-chunk state

    # inter-chunk recurrence: inclusive states at chunk ends
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (b,nc,h)
    S_inc = _linear_scan(chunk_decay[..., None, None], S, dim=1)
    S_prev = torch.cat([torch.zeros_like(S_inc[:, :1]), S_inc[:, :-1]],
                       dim=1)  # state entering each chunk

    decay_in = torch.exp(a_cum)  # (b,nc,q,h) decay from chunk start to step
    y_inter = (torch.einsum("bcsn,bchnp->bcshp", Cc, S_prev)
               * decay_in[..., None])

    y = (y_intra + y_inter).reshape(b, l, h, p)
    y = y + x * D[None, None, :, None]
    final_state = S_inc[:, -1].transpose(-1, -2)  # (b,h,n,p)->(b,h,p,n)
    return y[:, :l_orig], final_state


def _mamba2_in(p, cfg: SSMCfg, x, conv_state=None):
    """The block's input projections, conv and gates: (z, ubc_raw,
    new conv state, u, B, C, dt, A)."""
    H, P, N = cfg.num_heads, cfg.head_dim, cfg.state_dim
    inner = H * P
    z = F.silu(x @ p["in_z"])
    ubc_raw = torch.cat([x @ p["in_x"], x @ p["in_B"], x @ p["in_C"]],
                        dim=-1)
    ubc, new_state = _causal_conv1d(ubc_raw, p["conv"], conv_state)
    ubc = F.silu(ubc)
    u, Bm, Cm = (ubc[..., :inner], ubc[..., inner:inner + N],
                 ubc[..., inner + N:])
    dt = F.softplus((x @ p["in_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return z, ubc_raw, new_state, u, Bm, Cm, dt, A


def mamba2_train(p, cfg: SSMCfg, x, with_state: bool = False):
    """Full-sequence Mamba2 block.  ``with_state`` (prefill) also returns
    the conv's input (B,S,inner+2N) and the final SSM state (B,H,P,N)."""
    H, P = cfg.num_heads, cfg.head_dim
    z, ubc_raw, _, u, Bm, Cm, dt, A = _mamba2_in(p, cfg, x)
    u4 = u.reshape(u.shape[0], u.shape[1], H, P).float()
    y, final = ssd_chunked_with_state(u4, dt, A, Bm.float(), Cm.float(),
                                      p["D"], cfg.chunk)
    y = y.reshape(x.shape[0], x.shape[1], H * P).to(x.dtype) * z
    out = y @ p["out"]
    return (out, ubc_raw, final) if with_state else out


def mamba2_decode(p, cfg: SSMCfg, x, cache):
    """One-token SSM step.  cache: {"ssm": (B,H,P,N) fp32, "conv":
    (B,W-1,ch)}, written in place; returns (out, cache)."""
    H, P = cfg.num_heads, cfg.head_dim
    z, _, conv_state, u, Bm, Cm, dt, A = _mamba2_in(p, cfg, x, cache["conv"])
    dt = dt[:, 0]  # (B,H)
    u4 = u[:, 0].reshape(-1, H, P).float()
    decay = torch.exp(A[None] * dt)  # (B,H)
    # h' = decay * h + dt * B x^T ;  y = C . h' + D x
    hB = torch.einsum("bhp,bn,bh->bhpn", u4, Bm[:, 0].float(), dt)
    h = cache["ssm"] * decay[..., None, None] + hB
    y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0].float())
    y = y + u4 * p["D"][None, :, None]
    y = y.reshape(-1, 1, H * P).to(x.dtype) * z
    out = y @ p["out"]
    cache["ssm"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out, cache


def init_mamba2_cache(cfg: SSMCfg, batch, dtype, device=None, lead=()):
    H, P, N = cfg.num_heads, cfg.head_dim, cfg.state_dim
    ch = H * P + 2 * N
    lead = tuple(lead)
    return {"ssm": torch.zeros(lead + (batch, H, P, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, ch),
                                dtype=dtype, device=device)}
