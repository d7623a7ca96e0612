"""Decoder-only language models (``"family": "transformer"``), trained on
per-client token streams through the program's ``ArraySupplier``."""
from __future__ import annotations

import math

import torch

from pb import costs
from reference import fed as ref_fed
from reference import transformer as ref_model


def _leaves(cfg):
    """(path, shape, scale) in the program's ``init_model`` layout and
    order; scale None marks a norm (ones).  Weights are normal with the
    program's scales: 0.02 for the embedding, fan-in over the leading
    dims otherwise."""
    d, f, v, n = cfg["d_model"], cfg["d_ff"], cfg["vocab"], cfg["n_layers"]
    h, kh, dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    pre = ("stack", "b0")
    return [
        (("embed",), (v, d), 0.02),
        (pre + ("norm1",), (n, d), None),
        (pre + ("mixer", "wq"), (n, d, h, dh), 1 / math.sqrt(d * h)),
        (pre + ("mixer", "wk"), (n, d, kh, dh), 1 / math.sqrt(d * kh)),
        (pre + ("mixer", "wv"), (n, d, kh, dh), 1 / math.sqrt(d * kh)),
        (pre + ("mixer", "wo"), (n, h, dh, d), 1 / math.sqrt(h * dh)),
        (pre + ("norm2",), (n, d), None),
        (pre + ("mlp", "w_gate"), (n, d, f), 1 / math.sqrt(d)),
        (pre + ("mlp", "w_up"), (n, d, f), 1 / math.sqrt(d)),
        (pre + ("mlp", "w_down"), (n, f, d), 1 / math.sqrt(f)),
        (("final_norm",), (d,), None),
    ]


def init_params(cfg, seed: int, device) -> dict:
    """Float32 weights drawn on ``device`` by one generator seeded with
    ``seed``, in one call; the leaves are views of that one buffer."""
    leaves = _leaves(cfg)
    total = sum(math.prod(s) for _, s, sc in leaves if sc is not None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out: dict = {}
    off = 0
    for path, shape, scale in leaves:
        if scale is None:
            t = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            k = math.prod(shape)
            t = flat[off:off + k].view(shape).mul_(scale)
            off += k
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return out


def port_grad_fn(cfg):
    """The program's ``(params, batch) -> (loss, grads)`` for ``cfg``.  The
    program's model has RMSNorm, rotary embedding on the whole head and no
    attention bias, and runs its products in float32 with TF32 off
    (``device.full_fp32``); a configuration that states otherwise is
    refused, as the reference refuses it."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    ref_model.require_architecture(cfg)

    arch = T.ArchConfig(
        name=cfg["name"], family="dense", n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], d_ff=cfg["d_ff"], vocab=cfg["vocab"],
        attn=L.AttnCfg(kind="gqa", num_heads=cfg["num_heads"],
                       num_kv_heads=cfg["num_kv_heads"],
                       head_dim=cfg["head_dim"],
                       rope_theta=cfg["rope_theta"]),
        block_pattern=("attn",), mlp_kind="dense", act=cfg["act"],
        tie_embeddings=cfg["tie_embeddings"], norm_eps=cfg["norm_eps"],
        param_dtype=getattr(torch, cfg["param_dtype"]))
    return T.make_grad_fn(arch)


class Feed:
    """The program's ``ArraySupplier`` over the token streams, and the
    reference's own derivation of the batches it samples."""

    def __init__(self, traffic, streams, seed: int, device):
        from repro_torch.exec import ArraySupplier

        self.arrays = {"tokens": streams}
        self.traffic, self.seed, self.device = traffic, seed, device
        self.supplier = ArraySupplier(self.arrays, traffic["tau"],
                                      traffic["batch"], seed=seed,
                                      device=device)

    def reference_batches(self, rounds: int) -> list:
        out = ref_fed.array_supplier_batches(
            self.arrays, self.traffic["tau"], self.traffic["batch"],
            self.seed, rounds)
        return [{k: torch.as_tensor(v, device=self.device)
                 for k, v in b.items()} for b in out]


def reference_loss_and_grad(cfg, precision: str):
    return ref_model.loss_and_grad(cfg, precision)


def costs_of(cfg, traffic) -> dict:
    """What the readers divide by: the model's operations a round, and
    kernel 1's and the attention kernels' bounds a round."""
    n, tau, b, s = (traffic["clients"], traffic["tau"], traffic["batch"],
                    traffic["seq"])
    h, kh, dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    n_params = ref_model.count_params(cfg)
    seqs = n * tau * b
    calls = tau * cfg["n_layers"]  # each kernel: once a layer and step
    fwd = costs.flash_forward(n * b, s, h, kh, dh)
    bwd = costs.flash_backward(n * b, s, h, kh, dh)
    return {
        "model_flops_per_round": costs.transformer_train_flops(
            n_params, seqs * s, seqs, s, cfg["n_layers"], h, dh),
        "k1_bound_s_per_round": tau * costs.fused_prox_bytes(
            n_params, n, 4) / costs.HBM_BYTES_PER_S,
        "flash_bound_s_per_round": calls * (costs.bound_s(*fwd)
                                            + costs.bound_s(*bwd)),
    }
