"""The arithmetic the reference runs in.

``exact`` is float32 with TF32 off, the precision both configurations
state.  ``tf32`` is the control: every operand of a matrix product or a
convolution rounded to TF32 (10 mantissa bits, to nearest, ties away from
zero, as the tensor cores' conversion), in the forward and the backward
products alike, with float32 accumulation.  The rounding is done by
integer operations, so the control reads the same on the card and on the
CPU, whatever the library's TF32 switches say.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("exact", "tf32")


def require(cfg: dict, fixed: dict) -> None:
    """Refuse a configuration whose keys in ``fixed`` state anything other
    than what the reference computes (and the program is built as)."""
    wrong = {k: cfg.get(k) for k, v in fixed.items() if cfg.get(k) != v}
    if wrong:
        raise ValueError(f"configuration {cfg.get('name')!r} states {wrong}; "
                         f"the reference computes only {fixed}")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) with its mantissa rounded to TF32's 10 bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32)


class _Operand(torch.autograd.Function):
    """A product's operand: rounded going forward; the gradient passes back
    through it as the product computed it (float32)."""

    @staticmethod
    def forward(x):
        return round_tf32(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """A product's result: unchanged going forward (the accumulation is
    float32), its incoming gradient rounded (an operand of the backward
    products)."""

    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def product(precision: str, fn, *operands):
    """``fn(*operands)`` (a matrix product or a convolution; bias-free) in
    ``precision``."""
    if precision == "exact":
        return fn(*operands)
    if precision != "tf32":
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return _Output.apply(fn(*(_Operand.apply(x) for x in operands)))


@contextlib.contextmanager
def library_fp32():
    """PyTorch's own TF32 switches off inside the block (cuDNN's is on by
    default), so every product the reference runs is float32 unless
    :func:`product` rounds its operands."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(matmul)
