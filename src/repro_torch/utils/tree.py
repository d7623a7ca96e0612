"""Pytree arithmetic helpers over ``torch.utils._pytree``.

The counterpart of :mod:`repro.utils.tree`.  Params are dicts of tensors and
states are ``NamedTuple``s; ``torch.utils._pytree`` treats both as pytree
nodes natively (a ``NamedTuple`` subclass needs no registration of its own).

One difference to the JAX reference has to be bridged: ``jax.tree_util``
lists the leaves of a dict in sorted-key order, ``torch.utils._pytree`` in
insertion order.  :func:`tree_flatten` / :func:`tree_leaves` here return
JAX's order, so flat planes, leaf-ordered reductions and anything zipped
leaf by leaf line up with the reference.  ``tree_map`` needs no such care:
it matches dict children by key.
"""
from __future__ import annotations

import functools

import torch
import torch.utils._pytree as pytree

Params = object  # any pytree of tensors


def _canonical(tree):
    """``tree`` with every dict rebuilt in sorted-key order (JAX's leaf
    order); other containers are rebuilt around their canonical children."""
    if type(tree) is dict:
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_canonical(x) for x in tree))
    if type(tree) in (list, tuple):
        return type(tree)(_canonical(x) for x in tree)
    return tree


def canonical(tree):
    """``tree`` with its dicts in sorted-key order: the tree ``jax.tree_util``
    (``tree_map``, ``eval_shape``) would give back for it.  Serializers that
    keep a dict's insertion order (the wire codec) use it to write the
    reference's bytes."""
    return _canonical(tree)


def tree_flatten(tree):
    """(leaves, treespec) with leaves in ``jax.tree_util`` order."""
    return pytree.tree_flatten(_canonical(tree))


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_unflatten(treespec, leaves):
    return pytree.tree_unflatten(leaves, treespec)


def tree_map(fn, tree, *rest):
    return pytree.tree_map(fn, tree, *rest)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y."""
    return tree_map(lambda u, v: alpha * u + v, x, y)


def tree_lincomb(coeffs, trees):
    """sum_i coeffs[i] * trees[i]."""
    out = tree_scale(trees[0], coeffs[0])
    for c, t in zip(coeffs[1:], trees[1:]):
        out = tree_axpy(c, t, out)
    return out


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def _f32_zero(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.float32, device=device)


def tree_dot(a, b):
    """Sum of leafwise products, each leaf reduced in float32 (as the
    reference does) and the leaves summed in the reference's order."""
    leaves = tree_leaves(
        tree_map(lambda x, y: torch.sum(x.float() * y.float()), a, b))
    return functools.reduce(torch.add, leaves, _f32_zero(a))


def tree_sqnorm(a):
    return tree_dot(a, a)


def tree_norm(a):
    return torch.sqrt(tree_sqnorm(a))


def tree_l1(a):
    leaves = tree_leaves(tree_map(lambda x: torch.sum(torch.abs(x.float())), a))
    return functools.reduce(torch.add, leaves, _f32_zero(a))


def tree_size(a) -> int:
    return sum(int(x.numel()) for x in tree_leaves(a))


def tree_mean_over_axis0(a):
    """Average a stacked-client pytree over the leading (client) axis."""
    return tree_map(lambda x: torch.mean(x, dim=0), a)


def tree_broadcast_axis0(a, n: int):
    """Replicate a pytree along a new leading (client) axis of size ``n``
    (an ``expand`` view, no copy)."""
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)), a)


def tree_index_axis0(a, i):
    return tree_map(lambda x: x[i], a)


def tree_stack_axis0(trees):
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_isfinite(a) -> torch.Tensor:
    leaves = tree_leaves(tree_map(lambda x: torch.all(torch.isfinite(x)), a))
    return functools.reduce(torch.logical_and, leaves,
                            torch.ones((), dtype=torch.bool))


def tree_cast(a, dtype):
    return tree_map(
        lambda x: x.to(dtype) if torch.is_floating_point(x) else x, a)
