"""Weights and states carried across from the JAX reference.

The reference's params, ``DProxState``, the baselines' states and the
async states arrive as numpy arrays (anything ``np.asarray`` accepts, JAX
arrays included) and leave as numpy arrays; this module imports neither
``jax`` nor ``repro``.  Tests feed both packages the same numbers through
it.

The reference's async states carry a ``clock_key`` (a ``jax.random`` key);
the port's carry none.  The key's draws reach the port as the clock's draw
source instead: :func:`clock_draws` wraps the normals (and, for a
non-persistent straggler clock, the bernoullis) the caller computed from
the key, in the order the clock consumes them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import baselines
from repro_torch.core.algorithm import DProxState
from repro_torch.utils import tree as tu

# the baselines' state types by name (the reference's names are the same)
_BASELINE_STATES = {k.__name__: k for k in (
    baselines._XState, baselines._DualState, baselines._FastDAState,
    baselines._ScaffoldState)}


def _array_to_tensor(x) -> torch.Tensor:
    """A host copy of ``x`` as a CPU tensor.  bfloat16 (which numpy lacks;
    the reference's arrays carry ``ml_dtypes.bfloat16``) crosses bitwise
    through a 16-bit integer view, without a float32 round trip."""
    arr = np.array(x, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16; only needed on the way out

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_torch(params, device, dtype=None):
    """A pytree of arrays -> the same pytree of tensors on ``device``: the
    reference's nested dicts and lists, its ``"stack"`` leaves with their
    leading period axis, bfloat16 leaves bitwise.  Floating leaves are cast
    to ``dtype`` when it is given."""
    dev = torch.device(device)

    def one(x):
        t = _array_to_tensor(x).to(dev)
        if dtype is not None and torch.is_floating_point(t):
            t = t.to(dtype)
        return t

    return tu.tree_map(one, params)


def params_to_numpy(params):
    """A pytree of tensors -> the same pytree of numpy arrays (host copies;
    bfloat16 leaves as ``ml_dtypes.bfloat16`` arrays, bitwise)."""
    return tu.tree_map(_tensor_to_array, params)


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


def baseline_state_to_torch(state, device, dtype=None):
    """A reference baseline state (``_XState``, ``_DualState``,
    ``_FastDAState`` or ``_ScaffoldState``, found by its type's name) of
    arrays -> the port's state of the same kind on ``device``: params-shaped
    fields through :func:`params_to_torch`, ``round`` as an int32 scalar."""
    kind = _BASELINE_STATES[type(state).__name__]
    dev = torch.device(device)
    return kind(**{
        f: (torch.tensor(int(np.asarray(state.round)), dtype=torch.int32,
                         device=dev) if f == "round"
            else params_to_torch(getattr(state, f), dev, dtype))
        for f in kind._fields})


def baseline_state_to_numpy(state):
    """The port's baseline state -> the same ``NamedTuple`` of numpy
    arrays."""
    return type(state)(**{f: params_to_numpy(getattr(state, f))
                          for f in state._fields})


def async_state_to_torch(sched, device):
    """A reference ``AsyncState`` or ``QueueState`` (report buffers as
    pytrees or planes, the staleness residual, the ledger; dtypes kept) ->
    the port's state of the same kind on ``device``, without the clock key
    (see the module docstring)."""
    from repro_torch.sched.aggregator import AsyncState, QueueState

    kind = QueueState if hasattr(sched, "slot_filled") else AsyncState
    return kind(**{f: params_to_torch(getattr(sched, f), device)
                   for f in kind._fields})


def async_state_to_numpy(sched):
    """The port's async state -> the same ``NamedTuple`` of numpy arrays."""
    return type(sched)(**{f: params_to_numpy(getattr(sched, f))
                          for f in sched._fields})


def clock_draws(normals, bernoullis=None):
    """The port's clock draw source from draws made with the reference's
    clock key: per commit one ``normal`` vector, then (non-persistent
    straggler clock) one ``bernoulli`` vector."""
    from repro_torch.comm import ReplayDraws

    seq = []
    for i, z in enumerate(normals):
        seq.append(np.asarray(z, np.float32))
        if bernoullis is not None:
            seq.append(np.asarray(bernoullis[i], bool))
    return ReplayDraws(seq)
