"""The paper's MNIST CNN classifier (Section 4.2), in PyTorch.

The counterpart of :mod:`repro.models.cnn`: two 3x3 'same' conv layers of
32 feature maps, each followed by 2x2 max pooling, then fully-connected
layers of 64, 32 and 10 units, ReLU hidden activations, softmax
cross-entropy.  The parameter count is exactly the paper's d = 112,394.

The parameters keep the reference's names and layouts -- NHWC activations,
HWIO conv kernels, ``(in, out)`` dense weights -- so a reference parameter
tree crosses with :func:`repro_torch.interop.params_to_torch` unchanged and
its sorted-key leaf order is the fused kernel's leaf order.  ``forward``
permutes to NCHW / OIHW for ``F.conv2d`` and back to NHWC before the
flatten, so ``fc1_w``'s rows read ``(h, w, c)`` as in the reference.

Plain functions on tensors: ``torch.func.vmap`` over clients and
``torch.func.grad_and_value`` compose with them.  On the card the
convolutions and matmuls run in full float32: :func:`full_fp32` turns
TF32 off around the forward and the backward (cuDNN allows TF32 by
default), so the card's trajectory stays within float32 rounding of the
CPU's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import full_fp32, resolve_device

_SHAPES = {
    "conv1_w": ((3, 3, 1, 32), 9),
    "conv1_b": ((32,), None),
    "conv2_w": ((3, 3, 32, 32), 9 * 32),
    "conv2_b": ((32,), None),
    "fc1_w": ((7 * 7 * 32, 64), 7 * 7 * 32),
    "fc1_b": ((64,), None),
    "fc2_w": ((64, 32), 64),
    "fc2_b": ((32,), None),
    "fc3_w": ((32, 10), 32),
    "fc3_b": ((10,), None),
}


def init_params(seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """He-normal weights and zero biases, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (so the card and the CPU get the
    same numbers), then moved to ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, (shape, fan_in) in _SHAPES.items():
        if fan_in is None:
            p = torch.zeros(shape, dtype=torch.float32)
        else:
            p = torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)
        params[name] = p.to(dtype).to(dev)
    return params


class _OIHW(torch.autograd.Function):
    """The OIHW view ``F.conv2d`` takes of an HWIO kernel.  Its gradient
    comes back in the parameter's own layout, HWIO-contiguous (one transpose
    copy), where a plain ``permute`` would hand back a strided view of the
    convolution's OIHW gradient: the fused local update then reads every
    gradient leaf in place."""

    generate_vmap_rule = True

    @staticmethod
    def forward(w):
        return w.permute(3, 2, 0, 1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad.permute(2, 3, 1, 0).contiguous()


def _conv(x, w, b):
    """'same' 3x3 conv of NCHW ``x`` with an HWIO kernel."""
    return F.conv2d(x, _OIHW.apply(w), b, padding=1)


def forward(params, images):
    """images: (B, 28, 28, 1) NHWC -> logits (B, 10)."""
    with full_fp32():
        x = images.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(_conv(x, params["conv1_w"],
                                      params["conv1_b"])), 2)
        x = F.max_pool2d(F.relu(_conv(x, params["conv2_w"],
                                      params["conv2_b"])), 2)
        # flatten in NHWC order, as the reference's fc1_w expects
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(x @ params["fc1_w"] + params["fc1_b"])
        x = F.relu(x @ params["fc2_w"] + params["fc2_b"])
        return x @ params["fc3_w"] + params["fc3_b"]


def loss_fn(params, batch):
    """batch: {"x": (B, 28, 28, 1), "y": (B,) int32 or int64}."""
    logp = F.log_softmax(forward(params, batch["x"]), dim=-1)
    y = batch["y"].to(torch.int64)
    return -torch.mean(torch.gather(logp, 1, y[:, None]))


_grad_and_value = torch.func.grad_and_value(loss_fn)


def make_grad_fn():
    """(params, batch) -> (loss, grads); composable with ``torch.func.vmap``.
    The backward convolutions run without TF32 too."""

    def fn(params, batch):
        with full_fp32():
            grads, loss = _grad_and_value(params, batch)
        return loss, grads

    return fn


def accuracy(params, images, labels, batch: int = 500) -> float:
    """Top-1 accuracy over ``images`` (numpy or tensors; moved to the
    parameters' device), in batches of ``batch``."""
    dev = params["fc3_b"].device
    images = torch.as_tensor(images, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    n = images.shape[0]
    for i in range(0, n, batch):
        logits = forward(params, images[i:i + batch])
        correct += torch.sum(torch.argmax(logits, -1)
                             == labels[i:i + batch])
    return int(correct) / n
