"""The common federated-algorithm interface.

The counterpart of the interface half of :mod:`repro.core.baselines`; the
six baselines themselves (FedMid, FedDA, FastFedDA, Scaffold, FedAvg,
FedProx) are not ported yet.

    alg.init(params0, n_clients) -> state
    alg.make_round_fn(grad_fn)   -> round_fn(state, batches) -> (state, info)
    alg.global_params(state)     -> deployable model

``batches`` leaves have leading dims ``(n_clients, tau, ...)`` exactly as in
:mod:`repro_torch.core.algorithm`.
"""
from __future__ import annotations

from typing import Any, Callable

Params = Any
GradFn = Callable[[Params, Any], tuple]


class FedAlgorithm:
    """Common algorithm interface.

    Every algorithm factors one round into a *local-compute* half and a
    *server-aggregate* half joined by an explicit uplink message pytree:

        local_fn(state, batches)      -> (msg, aux)
        server_fn(state, msg, aux)    -> (state, metrics)

    ``msg`` leaves carry a leading client axis and are the only tensors that
    cross the network; they are *innovation-encoded* (each client uplinks
    its delta relative to the broadcast reference).  ``aux`` stays
    client-resident; every aux leaf carries a leading client axis, and
    ``aux["round"]`` is the per-client report-round tag.  ``make_round_fn``
    is the dense composition of the two halves.

    ``state_roles`` declares the placement role of every state field:
    'server' (params-shaped), 'client' (params-shaped with a leading client
    axis) or 'scalar'.
    """

    name: str = "base"
    uplink_vectors: int = 1
    downlink_vectors: int = 1

    def init(self, params0: Params, n_clients: int):
        raise NotImplementedError

    def make_local_fn(self, grad_fn: GradFn):
        """Client half: ``local_fn(state, batches) -> (msg, aux)``."""
        raise NotImplementedError

    def make_server_fn(self):
        """Server half: ``server_fn(state, msg, aux) -> (state, metrics)``."""
        raise NotImplementedError

    def make_round_fn(self, grad_fn: GradFn):
        """One full round: the dense composition of the two halves."""
        local_fn = self.make_local_fn(grad_fn)
        server_fn = self.make_server_fn()

        def round_fn(state, batches):
            msg, aux = local_fn(state, batches)
            return server_fn(state, msg, aux)

        return round_fn

    def state_roles(self) -> dict:
        """Placement role per state field: 'server' | 'client' | 'scalar'."""
        raise NotImplementedError

    def global_params(self, state) -> Params:
        raise NotImplementedError
