"""A decoder-only transformer language model in plain PyTorch: the
reference for the ``transformer`` configurations.

Each layer is ``x + attn(rms_norm(x))`` then ``x + mlp(rms_norm(x))``:
causal grouped-query attention with rotary position embeddings on the
whole head (the halves rotated against each other), a SwiGLU MLP, RMSNorm
with a learned scale, and the output head tied to the token embedding.
The loss is the mean next-token cross-entropy over the whole vocabulary.

Parameters are a flat dict of tensors keyed by path, float32, the layers
stacked on a leading axis:

    embed (V, d); final_norm (d,)
    stack.b0.norm1 / stack.b0.norm2 (L, d)
    stack.b0.mixer.wq (L, d, H, Dh), .wk / .wv (L, d, KH, Dh), .wo (L, H, Dh, d)
    stack.b0.mlp.w_gate / .w_up (L, d, F), .w_down (L, F, d)

Every product goes through :func:`precision.product`, so the same code
is the reference (``exact``) and its control (``tf32``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import precision as P

PRE = "stack.b0."

#: what this reference computes, as a configuration file states it
ARCHITECTURE = {"norm": "rmsnorm", "rotary_fraction": 1.0, "qkv_bias": False,
                "tie_embeddings": True, "act": "swiglu",
                "param_dtype": "float32", "tf32": False}


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rotary(x, theta):
    """x: (B, S, heads, Dh); position s rotates pair (i, i + Dh/2) by the
    angle s * theta**(-i / (Dh/2))."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(cfg, prec, p, i, h):
    """Causal GQA of h (B, S, d) through layer ``i``'s projections."""
    bsz, s, _ = h.shape
    nh, kh, dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]

    def proj(w):
        return P.product(prec, lambda a, b: torch.einsum("bsd,dhk->bshk", a, b),
                         h, w)

    q = rotary(proj(p[PRE + "mixer.wq"][i]), cfg["rope_theta"])
    k = rotary(proj(p[PRE + "mixer.wk"][i]), cfg["rope_theta"])
    v = proj(p[PRE + "mixer.wv"][i])
    rep = nh // kh
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    logits = P.product(prec, lambda a, b: torch.einsum("bshk,bthk->bhst", a, b),
                       q, k) / math.sqrt(dh)
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = P.product(prec, lambda a, b: torch.einsum("bhst,bthk->bshk", a, b),
                    probs, v)
    return P.product(prec, lambda a, b: torch.einsum("bshk,hkd->bsd", a, b),
                     out, p[PRE + "mixer.wo"][i])


def mlp(prec, p, i, h):
    def mm(a, w):
        return P.product(prec, torch.matmul, a, w)

    gate = mm(h, p[PRE + "mlp.w_gate"][i])
    up = mm(h, p[PRE + "mlp.w_up"][i])
    return mm(F.silu(gate) * up, p[PRE + "mlp.w_down"][i])


def loss(cfg, prec, p, tokens):
    """Mean next-token cross-entropy of ``tokens`` (B, S)."""
    eps = cfg["norm_eps"]
    x = p["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        x = x + attention(cfg, prec, p, i,
                          rms_norm(x, p[PRE + "norm1"][i], eps))
        x = x + mlp(prec, p, i, rms_norm(x, p[PRE + "norm2"][i], eps))
    x = rms_norm(x, p["final_norm"], eps)
    logits = P.product(prec, lambda a, b: a @ b.t(), x, p["embed"])
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


def require_architecture(cfg) -> None:
    P.require(cfg, ARCHITECTURE)


def loss_and_grad(cfg, prec: str = "exact"):
    """``fn(params, batch) -> (loss, grads)`` for one client's batch
    ``{"tokens": (B, S)}``."""
    require_architecture(cfg)

    def fn(params, batch):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with P.library_fp32():
            value = loss(cfg, prec, leaves, batch["tokens"])
            grads = torch.autograd.grad(value, list(leaves.values()))
        return value.detach(), dict(zip(leaves, grads))

    return fn


def count_params(cfg) -> int:
    """The parameter count of the layout above."""
    d, f, v, n = cfg["d_model"], cfg["d_ff"], cfg["vocab"], cfg["n_layers"]
    h, kh, dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    per_layer = 2 * d + d * dh * (2 * h + 2 * kh) + 3 * d * f
    return v * d + d + n * per_layer
