"""Pytree, plane and attention entry points of the port's kernels.

The counterpart of :mod:`repro.kernels.ops` for the fused local update,
the flat-plane compression kernels and flash attention.  The fused local
update reads the whole tree's leaves in place in one kernel launch
(:func:`repro_torch.kernels.fused_prox.fused_local_update`: no flatten
before it) and writes two planes whose leaves are views.  With
``batch_dims=1`` the client axis is the planes' rows, so one launch covers
every client -- the reference's ``vmap`` over clients
(``repro/core/algorithm.py:185-188``) is not needed.  Mixed-dtype trees
cannot share a plane and raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_prox, plane_ops


# Fused Algorithm-1 local update + L1 prox over a whole pytree: returns
# ``(z_hat_next, z_next)`` with ``z_hat``'s structure, shapes and dtype, each
# leaf a view of one output plane (one kernel launch on the card).
fused_local_update = fused_prox.fused_local_update


def fused_local_update_step(reg, eta: float, t: int, z_hat, grads, c, *,
                            thresh: float | None = None, batch_dims: int = 0):
    """Drop-in for :func:`repro_torch.core.algorithm.local_update_step` when
    ``reg`` is an unmasked L1.  ``thresh`` defaults to the paper's linear
    schedule ``(t+1)*eta*lam``."""
    from repro_torch.core.prox import L1

    if not isinstance(reg, L1) or reg.mask is not None:
        raise ValueError("the fused kernel path needs an unmasked L1 "
                         "regularizer")
    if thresh is None:
        thresh = (t + 1) * eta * reg.lam
    return fused_local_update(z_hat, grads, c, eta, thresh,
                              batch_dims=batch_dims)


# ---------------------------------------------------------------------------
# flat-plane communication kernels
# ---------------------------------------------------------------------------


def plane_threshold_select(flat_plane, thresh):
    """Global top-k select on a ``(clients, d_pad)`` plane: keep the
    coordinates whose magnitude reaches the per-client ``thresh``, zero the
    rest (one kernel launch; the k-th values come from ``torch.topk``)."""
    return plane_ops.threshold_select_2d(flat_plane.contiguous(), thresh)


def plane_quantize(flat_plane, u, scale, levels: int):
    """Stochastic uniform quantization of a ``(clients, d_pad)`` plane given
    the uniform draws ``u`` and per-client ``scale`` magnitudes (one kernel
    launch)."""
    return plane_ops.quantize_2d(flat_plane.contiguous(), u.contiguous(),
                                 scale, levels)


def plane_weighted_commit(buf, w):
    """Staleness-weighted buffered commit on a ``(clients, d_pad)``
    report plane: ``sum_i w[i] * buf[i]`` over the client axis, clients
    added in order, as one kernel launch.  ``w`` holds the mixing weights,
    zero for undelivered clients.  Returns the ``(d_pad,)`` row."""
    return plane_ops.weighted_commit_2d(buf.contiguous(), w)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def gqa_flash_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """Flash attention for ``(B, S, H, D)`` activations with K kv heads
    (``k``, ``v``: ``(B, S, K, D)``); returns ``(B, S, H, D)``.

    On CUDA tensors one kernel launch reads the kv heads in place (no
    repeat, no transposes) at any S; the kernel owns its tiling, so there
    are no block-size arguments.  On CPU tensors the plain version runs
    after repeating the kv heads (``repro.kernels.ops.gqa_flash_attention``
    repeats them on every backend).  Differentiable through
    :class:`~repro_torch.kernels.flash_attention.FlashAttention` (the
    backward kernel on the card), ``torch.func.grad`` and ``vmap``
    included; float32 only under autograd (bfloat16 and float16 raise
    ``NotImplementedError`` when a gradient is asked for).
    """
    if (q.dtype != torch.float32 and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        raise NotImplementedError(
            f"flash attention's backward is float32 only; got {q.dtype} "
            f"under autograd")
    return fa.FlashAttention.apply(q, k, v, causal, window, softcap)[0]
