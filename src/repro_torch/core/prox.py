"""Convex (possibly non-smooth) regularizers ``g`` and their proximal operators.

The counterpart of :mod:`repro.core.prox`.  Every regularizer exposes

  * ``value(tree)``        -- g(x)
  * ``prox(tree, eta)``    -- P_eta(x) = argmin_u  eta*g(u) + 1/2 ||x-u||^2
  * ``subgrad_bound(tree_or_size)`` -- the constant B_g of Assumption 3.1

Proximal operators are applied leaf-wise over parameter pytrees; an optional
``mask`` pytree of booleans restricts regularization to selected leaves.
Ported so far: ``Zero`` and ``L1``, the regularizers of the Fig. 2 path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.utils import tree as tu


def _masked_map(fn, tree, mask):
    if mask is None:
        return tu.tree_map(fn, tree)
    return tu.tree_map(lambda x, m: fn(x) if m else x, tree, mask)


def _masked_sum(fn, tree, mask):
    if mask is None:
        leaves = [fn(x) for x in tu.tree_leaves(tree)]
    else:
        leaves = [fn(x) for x, m in zip(tu.tree_leaves(tree),
                                        tu.tree_leaves(mask)) if m]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    total = leaves[0]
    for l in leaves[1:]:
        total = total + l
    return total


class Regularizer:
    """Interface for a convex regularizer with a cheap proximal operator."""

    mask = None  # optional pytree of bools mirroring the params

    def value(self, tree):
        raise NotImplementedError

    def prox(self, tree, eta):
        raise NotImplementedError

    def subgrad_bound(self, tree) -> float:
        raise NotImplementedError

    def with_mask(self, mask):
        import copy

        new = copy.copy(self)
        new.mask = mask
        return new


@dataclass
class Zero(Regularizer):
    """g = 0 (smooth problem).  prox is the identity."""

    mask = None

    def value(self, tree):
        return torch.zeros((), dtype=torch.float32)

    def prox(self, tree, eta):
        return tree

    def subgrad_bound(self, tree) -> float:
        return 0.0


def soft_threshold(x, thresh):
    """Leafwise prox of ``thresh * ||.||_1`` (shrinkage operator)."""
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - thresh, 0.0)


@dataclass
class L1(Regularizer):
    """g(x) = lam * ||x||_1  -- the paper's main running example.

    B_g = lam * sqrt(d): each coordinate subgradient is in [-lam, lam].
    """

    lam: float
    mask = None

    def value(self, tree):
        return self.lam * _masked_sum(
            lambda x: torch.sum(torch.abs(x.float())), tree, self.mask)

    def prox(self, tree, eta):
        t = eta * self.lam
        return _masked_map(lambda x: soft_threshold(x, t).to(x.dtype), tree,
                           self.mask)

    def subgrad_bound(self, tree) -> float:
        return self.lam * math.sqrt(tu.tree_size(tree))
