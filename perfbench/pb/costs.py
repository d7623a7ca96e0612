"""The yardstick: the chip's peaks and the operations and bytes each piece
of work needs, counted from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense.
Both configurations compute in float32, so the operations bound is taken
at the fastest rate the card multiplies float32 operands at, dense TF32
(495 TFLOP/s): no float32-exact path can read above it.  The CUDA cores'
float32 rate (67 TFLOP/s) is the rate the programs' float32 GEMMs run at
with TF32 off; it is kept here for reference, not divided by.

Bytes count each input read once and each output written once.
Operations count two per multiply-add, of the work the algorithm needs:
no recomputation (the flash backward's recomputed scores are not
counted), and no gradient of an input that needs none.
"""
from __future__ import annotations

TF32_FLOPS = 495e12
FP32_SIMT_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: operations or bytes."""
    return max(ops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


def causal_pairs(s: int) -> int:
    """Query-key pairs a causal mask admits in a sequence of ``s``."""
    return s * (s + 1) // 2


def transformer_train_flops(n_params: int, tokens: int, sequences: int,
                            seq: int, n_layers: int, heads: int,
                            head_dim: int) -> float:
    """Forward and backward of a decoder over ``tokens`` in ``sequences``:
    6 N per token for the products with the weights (the tied head's
    included, the embedding lookup costing none), plus causal attention,
    whose scores and weighted sum take 4 operations per admitted pair,
    head and head-dimension forward and 8 backward."""
    attn = 12 * causal_pairs(seq) * heads * head_dim * n_layers * sequences
    return 6.0 * n_params * tokens + attn


def conv_macs(hw: int, c_in: int, c_out: int, k: int) -> int:
    return hw * hw * c_out * k * k * c_in


def cnn_train_flops_per_example(image: list, conv_channels: list, k: int,
                                pool: int, dense: list) -> float:
    """Forward (2 per multiply-add), the weights' gradients (2) and the
    inputs' gradients (2) of every layer but the first: the images need
    no gradient."""
    hw, c = image[0], image[2]
    macs = []
    for c_out in conv_channels:
        macs.append(conv_macs(hw, c, c_out, k))
        hw, c = hw // pool, c_out
    width = hw * hw * c
    for units in dense:
        macs.append(width * units)
        width = units
    return 6.0 * sum(macs) - 2.0 * macs[0]


def fused_prox_bytes(n_params: int, clients: int, itemsize: int) -> int:
    """Kernel 1, one local step over every client: z_hat, the gradient and
    the correction read, z_hat and z written."""
    return 5 * n_params * clients * itemsize


def flash_forward(b: int, s: int, h: int, kh: int, d: int,
                  itemsize: int = 4) -> tuple:
    """(operations, bytes) of causal attention's forward with the row
    log-sum-exp kept for the backward: q, k, v read, out and lse written."""
    ops = 4 * causal_pairs(s) * h * d * b
    nbytes = itemsize * (b * s * d * (2 * h + 2 * kh) + b * h * s)
    return ops, nbytes


def flash_backward(b: int, s: int, h: int, kh: int, d: int,
                   itemsize: int = 4) -> tuple:
    """(operations, bytes) of its backward: q, k, v, out, d_out and the
    lse read, dq, dk, dv written."""
    ops = 8 * causal_pairs(s) * h * d * b
    nbytes = itemsize * (b * s * d * (3 * h + 2 * kh) + b * h * s
                         + b * s * d * (h + 2 * kh))
    return ops, nbytes
