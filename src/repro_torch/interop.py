"""Weights and states carried across from the JAX reference.

The reference's params and ``DProxState`` arrive as numpy arrays (anything
``np.asarray`` accepts, JAX arrays included) and leave as numpy arrays; this
module imports neither ``jax`` nor ``repro``.  Tests feed both packages the
same numbers through it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.algorithm import DProxState
from repro_torch.utils import tree as tu


def params_to_torch(params, device, dtype=None):
    """A pytree of arrays -> the same pytree of tensors on ``device``.
    Floating leaves are cast to ``dtype`` when it is given."""
    dev = torch.device(device)

    def one(x):
        t = torch.from_numpy(np.array(x, copy=True)).to(dev)
        if dtype is not None and torch.is_floating_point(t):
            t = t.to(dtype)
        return t

    return tu.tree_map(one, params)


def params_to_numpy(params):
    """A pytree of tensors -> the same pytree of numpy arrays (host copies)."""
    return tu.tree_map(lambda t: t.detach().cpu().numpy(), params)


def state_to_torch(state, device, dtype=None) -> DProxState:
    """A DProxState-shaped object (fields ``x_bar``, ``c``, ``round``) of
    arrays -> the port's :class:`DProxState` of tensors on ``device``."""
    return DProxState(
        x_bar=params_to_torch(state.x_bar, device, dtype),
        c=params_to_torch(state.c, device, dtype),
        round=torch.tensor(int(np.asarray(state.round)), dtype=torch.int32,
                           device=torch.device(device)),
    )


def state_to_numpy(state: DProxState) -> DProxState:
    """The port's state -> a :class:`DProxState` of numpy arrays."""
    return DProxState(x_bar=params_to_numpy(state.x_bar),
                      c=params_to_numpy(state.c),
                      round=state.round.detach().cpu().numpy())
