"""The paper's MNIST CNN (Section 4.2 of arXiv:2502.03958) in plain
PyTorch: the reference for the ``cnn`` configurations.

Two 3x3 'same' convolutions of 32 maps, each followed by ReLU and 2x2 max
pooling, then dense layers of 64, 32 and 10 units with ReLU between them,
softmax cross-entropy.  Parameters are a flat dict: ``conv{1,2}_w``
(3, 3, in, out) HWIO, ``conv{1,2}_b``, ``fc{1,2,3}_w`` (in, out) with the
features of ``fc1`` flattened in (h, w, c) order, ``fc{1,2,3}_b``.  Images
are NHWC.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import precision as P

#: what this reference computes, as a configuration file states it
ARCHITECTURE = {"param_dtype": "float32", "tf32": False}


def logits(cfg, prec, p, images):
    x = images.permute(0, 3, 1, 2)
    for j in range(1, len(cfg["conv_channels"]) + 1):
        w = p[f"conv{j}_w"].permute(3, 2, 0, 1)
        x = P.product(prec, lambda a, b: F.conv2d(a, b, padding=1), x, w)
        x = x + p[f"conv{j}_b"][None, :, None, None]
        x = F.max_pool2d(F.relu(x), cfg["pool"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    n = len(cfg["dense"])
    for j in range(1, n + 1):
        x = P.product(prec, torch.matmul, x, p[f"fc{j}_w"]) + p[f"fc{j}_b"]
        if j < n:
            x = F.relu(x)
    return x


def require_architecture(cfg) -> None:
    P.require(cfg, ARCHITECTURE)


def loss_and_grad(cfg, prec: str = "exact"):
    """``fn(params, batch) -> (loss, grads)`` for one client's batch
    ``{"x": (B, 28, 28, 1), "y": (B,)}``."""
    require_architecture(cfg)

    def fn(params, batch):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with P.library_fp32():
            value = F.cross_entropy(logits(cfg, prec, leaves, batch["x"]),
                                    batch["y"].long())
            grads = torch.autograd.grad(value, list(leaves.values()))
        return value.detach(), dict(zip(leaves, grads))

    return fn
