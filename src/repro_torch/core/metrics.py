"""Optimality metrics for composite problems.

The counterpart of :mod:`repro.core.metrics`.  The paper measures
first-order optimality via the prox-gradient mapping

    G(x) = (1/eta_tilde) * ( x - P_eta_tilde( x - eta_tilde * grad f(x) ) )

evaluated at the post-proximal global model x = P_eta_tilde(x_bar^r), and
reports  optimality := ||G(x^r)|| / ||G(x^1)||  in Fig. 2/3.  Norms reduce in
float32, as the reference's ``tree_norm`` does.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.prox import Regularizer
from repro_torch.utils import tree as tu

Params = Any


def prox_gradient_mapping(reg: Regularizer,
                          full_grad_fn: Callable[[Params], Params],
                          x: Params, eta_tilde: float) -> Params:
    """G(x) as a pytree (Eq. 11).  ``full_grad_fn`` must be deterministic."""
    g = full_grad_fn(x)
    inner = tu.tree_map(lambda xi, gi: xi - eta_tilde * gi, x, g)
    x_tilde = reg.prox(inner, eta_tilde)
    return tu.tree_map(lambda xi, xt: (xi - xt) / eta_tilde, x, x_tilde)


def prox_gradient_norm(reg: Regularizer,
                       full_grad_fn: Callable[[Params], Params],
                       x: Params, eta_tilde: float) -> torch.Tensor:
    return tu.tree_norm(prox_gradient_mapping(reg, full_grad_fn, x, eta_tilde))


def client_drift(z_stack: Params, anchor: Params) -> torch.Tensor:
    """sum_i ||z_i - anchor||^2 over the leading client axis."""
    sq = tu.tree_leaves(tu.tree_map(lambda z, a: torch.sum((z - a[None]) ** 2),
                                    z_stack, anchor))
    total = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    for s in sq:
        total = total + s
    return total


def sparsity(tree: Params, tol: float = 0.0) -> torch.Tensor:
    """Fraction of exactly-(or nearly-)zero coordinates -- checks that the
    'curse of primal averaging' (FedMid) is avoided."""
    nz = tu.tree_leaves(tu.tree_map(lambda x: torch.sum(torch.abs(x) <= tol),
                                    tree))
    return sum(nz) / tu.tree_size(tree)
