"""Sparse logistic regression (Section 4.1 of the paper).

    min_x  theta * ||x||_1 + (1/n) sum_i (1/m_i) sum_l log(1 + exp(-b_il a_il^T x))

The counterpart of :mod:`repro.models.logreg`.  Parameters are the dict
{"w": (d,), "b": ()}.  ``log(1 + exp(-m))`` is ``torch.logaddexp(0, -m)``,
the same function as ``jnp.logaddexp(0, -m)`` (``F.softplus`` switches to
the identity above ``threshold=20`` and is not).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def init_params(d: int, include_bias: bool = True, dtype=torch.float32,
                device=None):
    dev = resolve_device(device)
    p = {"w": torch.zeros((d,), dtype=dtype, device=dev)}
    if include_bias:
        p["b"] = torch.zeros((), dtype=dtype, device=dev)
    return p


def _log1p_exp_neg(margins):
    return torch.logaddexp(torch.zeros_like(margins), -margins)


def loss_fn(params, batch):
    """batch: {"a": (b, d), "y": (b,)} with y in {-1, +1}."""
    logits = batch["a"] @ params["w"]
    if "b" in params:
        logits = logits + params["b"]
    margins = batch["y"] * logits
    return torch.mean(_log1p_exp_neg(margins))


_grad_and_value = torch.func.grad_and_value(loss_fn)


def make_grad_fn():
    """(params, batch) -> (loss, grads); the GradFn interface of
    :mod:`repro_torch.core`.  Composable with ``torch.func.vmap``."""

    def fn(params, batch):
        grads, loss = _grad_and_value(params, batch)
        return loss, grads

    return fn


def full_gradient_fn(features, labels, *, device=None):
    """Deterministic full-dataset gradient of f = (1/n) sum_i f_i (all
    clients), for the prox-gradient-mapping optimality metric.  The data is
    moved to ``device`` once."""
    dev = resolve_device(device)
    a = torch.as_tensor(features.reshape(-1, features.shape[-1]), device=dev)
    y = torch.as_tensor(labels.reshape(-1), device=dev)

    def full_loss(params):
        logits = a @ params["w"]
        if "b" in params:
            logits = logits + params["b"]
        # mean over clients of per-client means == global mean when m_i equal
        return torch.mean(_log1p_exp_neg(y * logits))

    return torch.func.grad(full_loss)


def accuracy(params, features, labels) -> torch.Tensor:
    logits = features @ params["w"]
    if "b" in params:
        logits = logits + params["b"]
    return torch.mean((torch.sign(logits) == labels).to(torch.float32))
