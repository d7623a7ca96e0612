"""Single-process federated simulator.

The counterpart of :mod:`repro.fed.simulator`: runs an algorithm for R rounds
through a bare :class:`repro_torch.exec.RoundEngine` and records the metrics
the paper plots (relative prox-gradient optimality, loss, and whatever an
``eval_fn`` reports -- Fig. 4's test accuracy -- in ``History.extra``).
Between eval points the engine runs up to ``chunk_rounds`` rounds with one
host sync.  Any :class:`repro_torch.core.baselines.FedAlgorithm` runs
through it: DProx (wrapped by :class:`DProxAlgorithm`) and the six
baselines.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core import algorithm as alg_mod
from repro_torch.core.baselines import FedAlgorithm
from repro_torch.core.metrics import prox_gradient_norm
from repro_torch.core.prox import Regularizer
from repro_torch.exec import EngineConfig, RoundEngine, rounds_to_boundary
from repro_torch.utils import tree as tu


@dataclass
class DProxAlgorithm(FedAlgorithm):
    """Adapter exposing Algorithm 1 through the common FedAlgorithm interface."""

    reg: Regularizer
    cfg: alg_mod.DProxConfig
    name: str = "dprox"
    uplink_vectors: int = 1
    downlink_vectors: int = 1

    def init(self, params0, n_clients):
        self.cfg.validate(n_clients)
        return alg_mod.init_state(params0, n_clients)

    def make_local_fn(self, grad_fn):
        return alg_mod.make_local_fn(self.cfg, self.reg, grad_fn)

    def make_server_fn(self):
        return alg_mod.make_server_fn(self.cfg, self.reg)

    def make_round_fn(self, grad_fn):
        return alg_mod.make_round_fn(self.cfg, self.reg, grad_fn)

    def state_roles(self):
        return {"x_bar": "server", "c": "client", "round": "scalar"}

    def make_protocol_round_fn(self, grad_fn):
        """The literal per-client message-passing round (the engine's
        ``protocol=True`` mode); equal to the compact form up to the
        order of the client sums (App. A.1)."""

        def round_fn(state, batches):
            return alg_mod.run_per_client_round(
                self.cfg, self.reg, grad_fn, state, batches), {}

        return round_fn

    def global_params(self, state):
        return alg_mod.global_params(self.reg, self.cfg, state)


@dataclass
class History:
    rounds: list = field(default_factory=list)
    optimality: list = field(default_factory=list)
    loss: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)
    uplink_mbytes_per_round: float = 0.0

    def as_dict(self):
        return {
            "rounds": self.rounds,
            "optimality": self.optimality,
            "loss": self.loss,
            "uplink_mbytes_per_round": self.uplink_mbytes_per_round,
            **self.extra,
        }


def run(
    algorithm: FedAlgorithm,
    params0,
    grad_fn,
    batch_supplier: Callable[[int, np.random.Generator], Any],
    n_clients: int,
    rounds: int,
    *,
    reg: Optional[Regularizer] = None,
    eta_tilde: Optional[float] = None,
    full_grad_fn: Optional[Callable] = None,
    eval_fn: Optional[Callable[[Any], dict]] = None,
    eval_every: int = 1,
    seed: int = 0,
    engine: Optional[RoundEngine] = None,
    chunk_rounds: int = 8,
    participation: Optional[float] = None,
    device=None,
) -> History:
    """Run ``rounds`` federated rounds and record the paper's metrics.

    ``batch_supplier(round_idx, rng)`` (or a
    :class:`repro_torch.exec.BatchSupplier`) must return a pytree whose
    leaves have leading dims ``(n_clients, tau, ...)``.  If ``full_grad_fn``
    is given the relative prox-gradient optimality ||G(x^r)|| / ||G(x^1)||
    is recorded (the y-axis of the paper's Figs. 2-3).

    The run goes on ``device`` (``cuda`` unless given; it raises without a
    GPU).  ``engine`` overrides the default bare engine, and then its own
    device holds: e.g. ``RoundEngine(alg, grad_fn, n, EngineConfig(
    plane=True, transport=TopK(0.25, granularity="global")))`` for a
    compressed uplink, whose wire bytes then set
    ``History.uplink_mbytes_per_round``.
    """
    rng = np.random.default_rng(seed)
    if engine is None:
        engine = RoundEngine(
            algorithm, grad_fn, n_clients,
            EngineConfig(chunk_rounds=chunk_rounds,
                         participation=participation),
            device=device)
    state = engine.init(params0)

    hist = History()
    d = tu.tree_size(params0)
    hist.uplink_mbytes_per_round = (
        engine.algorithm.uplink_vectors * n_clients * d * 4 / 1e6)

    def evaluate(state, g0):
        x = engine.global_params(state)
        if full_grad_fn is not None and reg is not None and eta_tilde:
            gnorm = float(prox_gradient_norm(reg, full_grad_fn, x, eta_tilde))
            if g0 is None:
                g0 = max(gnorm, 1e-30)
            hist.optimality.append(gnorm / g0)
        if eval_fn is not None:
            for k, v in eval_fn(x).items():
                hist.extra.setdefault(k, []).append(float(v))
        return x, g0

    g0 = None
    r = 0
    while r < rounds:
        if r % eval_every == 0:
            _, g0 = evaluate(state, g0)
            hist.rounds.append(r)
        # rounds until the next eval point (chunked inside the engine)
        k = rounds_to_boundary(r, eval_every, rounds)
        state, metrics = engine.run(state, batch_supplier, k, rng=rng,
                                    start_round=r)
        hist.loss.extend(metrics.get("train_loss", []))
        r += k
    if engine.uplink_bytes_per_client_round is not None:
        # a communication stage: account the transport's actual wire bytes
        hist.uplink_mbytes_per_round = (
            engine.uplink_bytes_per_client_round * n_clients / 1e6)
    # final eval
    x, g0 = evaluate(state, g0)
    hist.rounds.append(rounds)
    hist.extra["final_params"] = x
    return hist
