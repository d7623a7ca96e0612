"""Convex (possibly non-smooth) regularizers ``g`` and their proximal operators.

The counterpart of :mod:`repro.core.prox`.  Every regularizer exposes

  * ``value(tree)``        -- g(x)
  * ``prox(tree, eta)``    -- P_eta(x) = argmin_u  eta*g(u) + 1/2 ||x-u||^2
  * ``subgrad_bound(tree_or_size)`` -- the constant B_g of Assumption 3.1

Proximal operators are applied leaf-wise over parameter pytrees; an optional
``mask`` pytree of booleans restricts regularization to selected leaves.
All six of the reference's regularizers are here: ``Zero``, ``L1``,
``ElasticNet``, ``GroupL2``, ``LinfBall`` and ``Nuclear`` (its SVD in
float32, as the reference's), and :func:`make_regularizer` builds one by
name.  Only an unmasked ``L1`` takes the fused local-update kernel.
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


@dataclass
class ElasticNet(Regularizer):
    """g(x) = lam1 * ||x||_1 + lam2/2 * ||x||^2.

    prox_eta(x) = soft_threshold(x, eta*lam1) / (1 + eta*lam2).
    ``subgrad_bound`` covers only the l1 part (the l2 part's subgradient is
    unbounded).
    """

    lam1: float
    lam2: float
    mask = None

    def value(self, tree):
        return _masked_sum(
            lambda x: self.lam1 * torch.sum(torch.abs(x.float()))
            + 0.5 * self.lam2 * torch.sum(x.float() ** 2),
            tree, self.mask)

    def prox(self, tree, eta):
        t = eta * self.lam1
        s = 1.0 / (1.0 + eta * self.lam2)
        return _masked_map(lambda x: (soft_threshold(x, t) * s).to(x.dtype),
                           tree, self.mask)

    def subgrad_bound(self, tree) -> float:
        return self.lam1 * math.sqrt(tu.tree_size(tree))


def _group_rows(x):
    """A leaf as the rows its groups are: the last-axis fibers (a vector is
    one group)."""
    return x.reshape(-1, x.shape[-1])


@dataclass
class GroupL2(Regularizer):
    """Group lasso: g(x) = lam * sum_groups ||x_group||_2, one group per
    last-axis fiber of each leaf (a vector or scalar leaf is one group).
    Computed in float32, as the reference."""

    lam: float
    mask = None

    def value(self, tree):
        def leaf(x):
            x = x.float()
            if x.ndim < 2:
                return torch.linalg.vector_norm(x)
            return torch.sum(torch.linalg.vector_norm(_group_rows(x),
                                                      dim=-1))

        return self.lam * _masked_sum(leaf, tree, self.mask)

    def prox(self, tree, eta):
        t = eta * self.lam

        def leaf(x):
            xf = x.float()
            if xf.ndim < 2:
                nrm = torch.linalg.vector_norm(xf)
                scale = torch.clamp_min(
                    1.0 - t / torch.clamp_min(nrm, 1e-12), 0.0)
                return (xf * scale).to(x.dtype)
            flat = _group_rows(xf)
            nrm = torch.linalg.vector_norm(flat, dim=-1, keepdim=True)
            scale = torch.clamp_min(1.0 - t / torch.clamp_min(nrm, 1e-12),
                                    0.0)
            return (flat * scale).reshape(xf.shape).to(x.dtype)

        return _masked_map(leaf, tree, self.mask)

    def subgrad_bound(self, tree) -> float:
        # ||subgrad||^2 = lam^2 * n_groups
        return self.lam * math.sqrt(sum(
            1 if x.ndim < 2 else x.numel() // x.shape[-1]
            for x in tu.tree_leaves(tree)))


@dataclass
class LinfBall(Regularizer):
    """Indicator of the box ||x||_inf <= radius; prox = clipping.  B_g = 0
    (see the reference)."""

    radius: float
    mask = None

    def value(self, tree):
        viol = _masked_sum(
            lambda x: torch.sum(torch.clamp_min(torch.abs(x) - self.radius,
                                                0.0)),
            tree, self.mask)
        return torch.where(viol > 0, torch.inf, 0.0)

    def prox(self, tree, eta):
        r = self.radius
        return _masked_map(lambda x: torch.clamp(x, -r, r), tree, self.mask)

    def subgrad_bound(self, tree) -> float:
        return 0.0


@dataclass
class Nuclear(Regularizer):
    """g(X) = lam * ||X||_* on matrix leaves (ndim 2, both sides > 1), L1 on
    the others; prox = singular-value soft-thresholding, the SVD in float32
    as in the reference."""

    lam: float
    mask = None

    @staticmethod
    def _is_mat(x):
        return x.ndim == 2 and min(x.shape) > 1

    def value(self, tree):
        def leaf(x):
            xf = x.float()
            if self._is_mat(xf):
                return torch.sum(torch.linalg.svdvals(xf))
            return torch.sum(torch.abs(xf))

        return self.lam * _masked_sum(leaf, tree, self.mask)

    def prox(self, tree, eta):
        t = eta * self.lam

        def leaf(x):
            if not self._is_mat(x):
                return soft_threshold(x, t).to(x.dtype)
            u, s, vt = torch.linalg.svd(x.float(), full_matrices=False)
            s = torch.clamp_min(s - t, 0.0)
            return ((u * s[None, :]) @ vt).to(x.dtype)

        return _masked_map(leaf, tree, self.mask)

    def subgrad_bound(self, tree) -> float:
        return self.lam * math.sqrt(sum(
            min(x.shape) if self._is_mat(x) else x.numel()
            for x in tu.tree_leaves(tree)))


REGISTRY = {
    "zero": Zero,
    "l1": L1,
    "elastic_net": ElasticNet,
    "group_l2": GroupL2,
    "linf_ball": LinfBall,
    "nuclear": Nuclear,
}


def make_regularizer(kind: str, **kwargs) -> Regularizer:
    return REGISTRY[kind](**kwargs)
