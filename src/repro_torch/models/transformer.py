"""Config-driven model stack covering the reference's ten architectures:
the port of :mod:`repro.models.transformer`.

A model is a sequence of blocks, each ``norm -> mixer -> residual [-> norm
-> mlp/moe -> residual]`` (gemma2's post-norms included).  Mixers:
``attn`` (full attention: causal or bidirectional GQA, or MLA), ``local``
(sliding-window attention, ``window = cfg.window_local``), ``rec`` (the
RG-LRU block of recurrentgemma) and ``ssm`` (the Mamba2 SSD block), with a
dense MLP, the MoE block (whose load-balance loss the stack sums) or none
(``mlp_kind="none"``: mamba2's block is its mixer).  The layer stack is
``prefix_blocks`` (deepseek-v3's dense layers) + a repeating
``block_pattern`` with its params stacked ``n_periods`` times (the
reference's ``lax.scan`` over periods is a Python loop over views of the
stacked params and caches here) + ``suffix_blocks``.

Front ends, as the reference's stubs: ``audio`` (hubert) projects
precomputed frame features (``batch["features"]``) into the model width;
``vision`` (internvl2) projects precomputed patch embeddings
(``batch["patches"]``) and prepends them to the embedded text tokens.

Entry points: ``forward``, ``loss_fn`` and ``make_grad_fn`` (training:
next-token cross-entropy, hubert's masked prediction, internvl2's text
loss, plus the MoE aux loss; gradients through ``torch.func``, so ``vmap``
over clients composes), ``prefill`` (logits + cache) and ``decode_step``
(one token against the cache, which is updated in place).

On the card, attention's forward and backward are the flash kernels
(``kernels/flash_attention.py``); the loss and its gradient run with TF32
off (:func:`repro_torch.device.full_fp32`), so a card's trajectory stays
within float32 rounding of the CPU's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.device import device_of, full_fp32
from repro_torch.models import layers as L
from repro_torch.utils import tree as tu


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The reference's ``ArchConfig``, its long-context fields
    (``long_mode``, ``long_window``, :meth:`long_context_variant`)
    included.  Not here: ``fed_plan`` (a mesh sharding tag that only the
    reference's TPU dry run reads) and ``scan_unroll`` (an XLA cost-probe
    switch).  ``causal`` is carried as the reference's, which reads the
    attention config's own flag (``attn.causal``) and not this one.

    ``remat`` is accepted and not honoured: ``torch.utils.checkpoint``
    rests on saved-tensor hooks, which ``torch.func.grad`` (the per-client
    gradient that ``vmap`` maps) refuses, so activations are kept as
    without it; it changes only memory, never the numbers."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: Optional[L.AttnCfg] = None
    moe: Optional[L.MoECfg] = None
    ssm: Optional[L.SSMCfg] = None
    rglru: Optional[L.RGLRUCfg] = None
    block_pattern: tuple = ("attn",)
    prefix_blocks: tuple = ()
    suffix_blocks: tuple = ()
    mlp_kind: str = "dense"  # mlp of the pattern: dense | moe | none
    prefix_mlp_kind: str = "dense"
    act: str = "swiglu"
    causal: bool = True
    tie_embeddings: bool = True
    scale_embed: bool = False  # gemma convention: embed * sqrt(d)
    final_softcap: Optional[float] = None
    post_norm: bool = False  # gemma2: extra norm after mixer/mlp outputs
    window_local: Optional[int] = None
    frontend: Optional[str] = None  # None | "audio" | "vision"
    frontend_dim: int = 0
    param_dtype: torch.dtype = torch.bfloat16
    norm_eps: float = 1e-6
    attn_impl: str = "naive"  # CPU formulation: naive | blocked
    attn_block_q: int = 512
    remat: bool = True  # accepted, not honoured (see the class docstring)
    aux_loss_coef: float = 0.01
    # deployment metadata, as the reference's
    long_mode: str = "sliding"  # native | sliding | skip
    long_window: int = 8192
    decode_supported: bool = True
    citation: str = ""

    @property
    def n_pattern_layers(self):
        return self.n_layers - len(self.prefix_blocks) - len(self.suffix_blocks)

    @property
    def n_periods(self):
        k = len(self.block_pattern)
        assert self.n_pattern_layers % k == 0, (
            f"{self.name}: {self.n_pattern_layers} pattern layers not divisible"
            f" by pattern {self.block_pattern}"
        )
        return self.n_pattern_layers // k

    def with_overrides(self, **kw):
        return dataclasses.replace(self, **kw)

    def long_context_variant(self):
        """Sub-quadratic variant used for the long_500k shape: every
        attention layer's window capped at ``long_window``."""
        if self.long_mode == "native":
            return self
        if self.long_mode == "skip":
            raise ValueError(f"{self.name} does not support long context")
        attn = dataclasses.replace(self.attn, window=self.long_window)
        return dataclasses.replace(self, attn=attn, window_local=min(
            self.window_local or self.long_window, self.long_window))


# ---------------------------------------------------------------------------
# block init / apply
# ---------------------------------------------------------------------------


def _mixer_cfg(cfg: ArchConfig, kind: str):
    if kind == "attn":
        return dataclasses.replace(cfg.attn, impl=cfg.attn_impl,
                                   block_q=cfg.attn_block_q)
    if kind == "local":
        return dataclasses.replace(cfg.attn, window=cfg.window_local,
                                   impl=cfg.attn_impl,
                                   block_q=cfg.attn_block_q)
    if kind == "rec":
        return cfg.rglru
    if kind == "ssm":
        return cfg.ssm
    raise ValueError(kind)


def init_block(gen, cfg: ArchConfig, kind: str, mlp_kind: str):
    def norm():
        return L.init_norm(cfg.d_model, torch.float32, gen.device)

    init_mixer = {"rec": L.init_rglru_block,
                  "ssm": L.init_mamba2_block}.get(kind, L.init_attention)
    p = {"norm1": norm(),
         "mixer": init_mixer(gen, _mixer_cfg(cfg, kind), cfg.d_model,
                             cfg.param_dtype)}
    if cfg.post_norm:
        p["post_norm1"] = norm()
    if mlp_kind == "dense":
        p["norm2"] = norm()
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype)
    elif mlp_kind == "moe":
        p["norm2"] = norm()
        p["moe"] = L.init_moe(gen, cfg.moe, cfg.d_model, cfg.param_dtype)
    if cfg.post_norm and mlp_kind != "none":
        p["post_norm2"] = norm()
    return p


def apply_block(p, cfg: ArchConfig, kind: str, mlp_kind: str, x, positions,
                mode: str, cache, cache_len):
    """Returns (x, cache, aux_loss); in decode and prefill mode ``cache``'s
    buffers are written in place."""
    mcfg = _mixer_cfg(cfg, kind)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    new_cache = cache
    if kind in ("attn", "local"):
        if mode == "decode":
            y, new_cache = L.attention_decode(p["mixer"], mcfg, h, cache,
                                              cache_len)
        else:
            y = L.attention_train(p["mixer"], mcfg, h, positions)
            if mode == "prefill":
                new_cache = _fill_attn_cache(p["mixer"], mcfg, h, positions,
                                             cache)
    else:  # rec | ssm
        train, decode, fill = _RECURRENT[kind]
        if mode == "decode":
            y, new_cache = decode(p["mixer"], mcfg, h, cache)
        elif mode == "prefill":
            y, conv_in, state = train(p["mixer"], mcfg, h, with_state=True)
            new_cache = fill(mcfg, conv_in, state, cache)
        else:
            y = train(p["mixer"], mcfg, h)
    if cfg.post_norm:
        y = L.rms_norm(y, p["post_norm1"], cfg.norm_eps)
    x = x + y
    aux = 0.0
    if mlp_kind != "none":
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        if mlp_kind == "dense":
            y = L.mlp(p["mlp"], h, cfg.act)
        else:
            y, aux = L.moe(p["moe"], cfg.moe, h, cfg.act)
        if cfg.post_norm:
            y = L.rms_norm(y, p["post_norm2"], cfg.norm_eps)
        x = x + y
    return x, new_cache, aux


# --- prefill cache fillers ---------------------------------------------------


def _ring_scatter(full, T):
    """full: (B,S,...) values for absolute positions 0..S-1; the last
    min(S,T) of them placed into a (B,T,...) ring buffer at slot p % T.

    The target slots form a contiguous cyclic range, so a pad (S <= T) or a
    roll (ring) does it."""
    B, S = full.shape[0], full.shape[1]
    if S <= T:
        pad = torch.zeros((B, T - S) + tuple(full.shape[2:]),
                          dtype=full.dtype, device=full.device)
        return torch.cat([full, pad], dim=1)
    # element i of `last` holds absolute position p = S-T+i and belongs at
    # slot p % T = (i + (S-T)) % T
    last = full[:, S - T:]
    return torch.roll(last, shifts=(S - T) % T, dims=1)


def _fill_attn_cache(p, mcfg: L.AttnCfg, h, positions, cache):
    """The prompt's K/V (MLA: its latent and rope key) written into
    ``cache``'s buffers in place."""
    if mcfg.kind == "mla":
        ckv, k_rope = L._mla_latent(p, mcfg, h, positions)
        T = cache["ckv"].shape[1]
        cache["ckv"].copy_(_ring_scatter(ckv.to(cache["ckv"].dtype), T))
        cache["k_rope"].copy_(_ring_scatter(
            k_rope[:, :, 0].to(cache["k_rope"].dtype), T))
        return cache
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    k = L.rope(k, positions, mcfg.rope_theta)
    T = cache["k"].shape[1]
    cache["k"].copy_(_ring_scatter(k.to(cache["k"].dtype), T))
    cache["v"].copy_(_ring_scatter(v.to(cache["v"].dtype), T))
    return cache


def _fill_rglru_cache(mcfg: L.RGLRUCfg, u, h_last, cache):
    """The prompt's RG-LRU state written into ``cache`` in place: the last
    scanned state and the conv's last W-1 inputs (zero-padded on the left
    for a shorter prompt).  The block's own prefill pass hands them over,
    where the reference recomputes the block to get them."""
    cache["h"].copy_(h_last)
    cache["conv"].copy_(L.conv_tail(u, mcfg.conv_width))
    return cache


def _fill_mamba2_cache(mcfg: L.SSMCfg, ubc_raw, state, cache):
    """The prompt's SSD state and conv tail written into ``cache`` in
    place.  A prompt shorter than ``conv_width - 1`` tokens gets a
    zero-padded conv tail, as ``_fill_rglru_cache``; the reference keeps
    it short there and fails on the next decode step."""
    cache["ssm"].copy_(state)
    cache["conv"].copy_(L.conv_tail(ubc_raw, mcfg.conv_width))
    return cache


#: the recurrent mixers: (full-sequence block, one-token step, prefill
#: cache filler)
_RECURRENT = {"rec": (L.rglru_block_train, L.rglru_block_decode,
                      _fill_rglru_cache),
              "ssm": (L.mamba2_train, L.mamba2_decode, _fill_mamba2_cache)}


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _block_sequence(cfg: ArchConfig):
    """[(kind, mlp_kind)] for prefix, pattern (one period) and suffix."""
    pat_mlp = "none" if cfg.mlp_kind == "none" else cfg.mlp_kind
    prefix = [(k, cfg.prefix_mlp_kind) for k in cfg.prefix_blocks]
    pattern = [(k, pat_mlp) for k in cfg.block_pattern]
    suffix = [(k, cfg.prefix_mlp_kind) for k in cfg.suffix_blocks]
    return prefix, pattern, suffix


def init_model(gen: torch.Generator, cfg: ArchConfig):
    """Seeded random params on ``gen``'s device, in the reference's layout
    (``embed``, ``prefix``/``suffix`` block lists, the ``stack`` of
    ``n_periods`` periods on a leading axis, ``final_norm``, ``unembed``
    when untied, ``frontend_proj`` with a front end).  The stacked periods
    are filled in place one period at a time, so the peak is the model plus
    one period."""
    prefix, pattern, suffix = _block_sequence(cfg)
    p = {"embed": L.init_embed(gen, cfg.vocab, cfg.d_model, cfg.param_dtype)}
    if cfg.frontend is not None:
        p["frontend_proj"] = L.init_dense(gen, (cfg.frontend_dim,
                                                cfg.d_model), cfg.param_dtype)
    for name, blocks in (("prefix", prefix), ("suffix", suffix)):
        if blocks:
            p[name] = [init_block(gen, cfg, kind, mk) for kind, mk in blocks]

    def one_period():
        return {f"b{j}": init_block(gen, cfg, kind, mk)
                for j, (kind, mk) in enumerate(pattern)}

    first = one_period()
    n = cfg.n_periods
    stack = tu.tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    tu.tree_map(lambda dst, src: dst[0].copy_(src), stack, first)
    del first
    for i in range(1, n):
        tu.tree_map(lambda dst, src: dst[i].copy_(src), stack, one_period())
    p["stack"] = stack
    p["final_norm"] = L.init_norm(cfg.d_model, torch.float32, gen.device)
    if not cfg.tie_embeddings:
        p["unembed"] = L.init_dense(gen, (cfg.d_model, cfg.vocab),
                                    cfg.param_dtype)
    return p


def _scaled(cfg: ArchConfig, x):
    """``x`` times sqrt(d_model) under ``scale_embed`` (gemma)."""
    if cfg.scale_embed:
        # sqrt(d) rounded to the embedding's dtype first, as the reference's
        # jnp.asarray(sqrt(d), x.dtype); a Python scalar, so no host-device
        # copy (and no host sync) per decode step
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
        x = x * scale
    return x


def _embed(p, cfg: ArchConfig, tokens):
    return _scaled(cfg, p["embed"][tokens])


def _embed_inputs(p, cfg: ArchConfig, batch):
    """Returns (x (B,S,d), positions (1,S)): the tokens' embeddings, or the
    front end's -- audio: the projected ``features`` (B,T,frontend_dim);
    vision: the projected ``patches`` (B,S_img,frontend_dim) followed by
    the embedded ``tokens``."""
    if cfg.frontend == "audio":
        x = batch["features"].to(cfg.param_dtype) @ p["frontend_proj"]
    elif cfg.frontend == "vision":
        img = batch["patches"].to(cfg.param_dtype) @ p["frontend_proj"]
        x = torch.cat([img, p["embed"][batch["tokens"]]], dim=1)
    else:
        x = p["embed"][batch["tokens"]]
    x = _scaled(cfg, x)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    return x, positions


def _period(tree, i):
    """Period ``i`` of a stacked tree: views, so writes reach the stack."""
    return tu.tree_map(lambda a: a[i], tree)


def _apply_stack(p, cfg: ArchConfig, x, positions, mode, caches, cache_len):
    """caches: {"prefix": [..], "stack": stacked, "suffix": [..]} or None;
    in prefill and decode mode their buffers are written in place and the
    same dict is returned."""
    prefix, pattern, suffix = _block_sequence(cfg)
    aux_total = 0.0

    def run_blocks(blocks, params_list, cache_list, x, aux_total):
        for j, (kind, mk) in enumerate(blocks):
            c = cache_list[j] if cache_list is not None else None
            x, _, aux = apply_block(params_list[j], cfg, kind, mk, x,
                                    positions, mode, c, cache_len)
            aux_total = aux_total + aux
        return x, aux_total

    if prefix:
        x, aux_total = run_blocks(prefix, p["prefix"],
                                  caches["prefix"] if caches else None,
                                  x, aux_total)
    for i in range(cfg.n_periods):
        pp = _period(p["stack"], i)
        pc = _period(caches["stack"], i) if caches else None
        for j, (kind, mk) in enumerate(pattern):
            c = pc[f"b{j}"] if pc is not None else None
            x, _, aux = apply_block(pp[f"b{j}"], cfg, kind, mk, x, positions,
                                    mode, c, cache_len)
            aux_total = aux_total + aux
    if suffix:
        x, aux_total = run_blocks(suffix, p["suffix"],
                                  caches["suffix"] if caches else None,
                                  x, aux_total)
    return x, caches, aux_total


def _logits(p, cfg: ArchConfig, x):
    x = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ p["embed"].t()
    else:
        logits = x @ p["unembed"]
    if cfg.final_softcap is not None:
        logits = L.softcap(logits.float(), cfg.final_softcap)
    return logits


def forward(p, cfg: ArchConfig, batch, mode="train", caches=None,
            cache_len=None, last_only=False):
    x, positions = _embed_inputs(p, cfg, batch)
    if mode == "decode":
        positions = None  # decode paths derive positions from cache_len
    x, new_caches, aux = _apply_stack(p, cfg, x, positions, mode, caches,
                                      cache_len)
    if last_only:
        # serving prefill: only the final position is sampled from; slicing
        # BEFORE the unembed removes the (B, S, V) materialization entirely
        x = x[:, -1:]
    return _logits(p, cfg, x), new_caches, aux


# --- losses ------------------------------------------------------------------


def _ce(logits, targets, mask=None):
    """Mean cross-entropy; with a float ``mask``, ``sum(nll * mask) /
    max(sum(mask), 1)``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def loss_fn(p, cfg: ArchConfig, batch):
    """The composite-FL smooth part f_i: the cross-entropy plus
    ``aux_loss_coef`` times the MoE blocks' load-balance loss (summed over
    the layers; 0 without MoE).  The cross-entropy is next-token over
    ``batch["tokens"]`` (B, S); for the audio front end, the prediction of
    ``batch["targets"]`` at the frames ``batch["mask"]`` marks (every frame
    without a mask); for the vision front end, next-token over the text
    positions only.  The non-smooth regularizer g is the federated
    algorithm's prox, not part of it."""
    with full_fp32():
        logits, _, aux = forward(p, cfg, batch, mode="train")
        if cfg.frontend == "audio":
            loss = _ce(logits, batch["targets"], batch.get("mask"))
        elif cfg.frontend == "vision":
            s_img = batch["patches"].shape[1]
            loss = _ce(logits[:, s_img:-1], batch["tokens"][:, 1:])
        else:
            loss = _ce(logits[:, :-1], batch["tokens"][:, 1:])
    return loss + cfg.aux_loss_coef * aux


def make_grad_fn(cfg: ArchConfig):
    """``(params, batch) -> (loss, grads)`` through
    ``torch.func.grad_and_value``, so ``torch.func.vmap`` over clients
    composes (the local step's pattern); the backward runs with TF32 off
    too."""
    gv = torch.func.grad_and_value(lambda p, b: loss_fn(p, cfg, b))

    def fn(params, batch):
        with full_fp32():
            grads, loss = gv(params, batch)
        return loss, grads

    return fn


# --- serving -----------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Zeroed cache buffers for the whole model, in the reference's layout
    (the stacked blocks' buffers with a leading ``n_periods`` axis)."""
    prefix, pattern, suffix = _block_sequence(cfg)

    def one(kind, lead=()):
        mcfg = _mixer_cfg(cfg, kind)
        if kind == "rec":
            return L.init_rglru_cache(mcfg, cfg.d_model, batch,
                                      cfg.param_dtype, device, lead)
        if kind == "ssm":
            return L.init_mamba2_cache(mcfg, batch, cfg.param_dtype, device,
                                       lead)
        return L.init_attn_cache(mcfg, batch, max_len, cfg.param_dtype,
                                 device, lead)

    return {"prefix": [one(kind) for kind, _ in prefix],
            "suffix": [one(kind) for kind, _ in suffix],
            "stack": {f"b{j}": one(kind, (cfg.n_periods,))
                      for j, (kind, _) in enumerate(pattern)}}


def prefill(p, cfg: ArchConfig, batch, max_len=None, last_only=False):
    """Forward over the prompt; returns (logits, caches, cache_len).

    ``last_only`` emits logits for the final position only (what a serving
    engine samples from).  The prompt's length S counts the image patches
    of a vision batch and the frames of an audio one."""
    if cfg.frontend == "audio":
        B, S = batch["features"].shape[:2]
    elif cfg.frontend == "vision":
        B = batch["tokens"].shape[0]
        S = batch["patches"].shape[1] + batch["tokens"].shape[1]
    else:
        B, S = batch["tokens"].shape
    caches = init_cache(cfg, B, max_len or S, device_of(p))
    logits, new_caches, _ = forward(p, cfg, batch, mode="prefill",
                                    caches=caches, cache_len=None,
                                    last_only=last_only)
    return logits, new_caches, torch.full((), S, dtype=torch.int32,
                                          device=logits.device)


def decode_step(p, cfg: ArchConfig, caches, token, cache_len):
    """One-token decode: token (B,1) int -> (logits (B,1,V), caches), the
    cache buffers updated in place."""
    x = _embed(p, cfg, token)
    x, new_caches, _ = _apply_stack(p, cfg, x, None, "decode", caches,
                                    cache_len)
    return _logits(p, cfg, x), new_caches


def count_params(params) -> int:
    return sum(int(x.numel()) for x in tu.tree_leaves(params))


def active_param_fraction(cfg: ArchConfig) -> float:
    """Fraction of MoE expert params active per token (for 6*N_active*D),
    the reference's per-layer approximation."""
    if cfg.moe is None:
        return 1.0
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    expert_p = 3 * cfg.d_model * cfg.moe.d_ff_expert  # per expert
    attn_p = 4 * cfg.d_model * cfg.d_model if cfg.attn else 0
    shared = (3 * cfg.d_model * cfg.moe.d_ff_shared) if cfg.moe.num_shared \
        else 0
    per_layer_total = attn_p + E * expert_p + shared
    per_layer_active = attn_p + K * expert_p + shared
    return per_layer_active / max(per_layer_total, 1)
