"""Baseline federated algorithms of the paper's experiments (Section 4),
plus two smooth-FL baselines for the ablation suite.

The counterpart of :mod:`repro.core.baselines`.  All algorithms share one
interface, so the simulator and the round engine swap them freely:

    alg.init(params0, n_clients) -> state
    alg.make_round_fn(grad_fn)   -> round_fn(state, batches) -> (state, info)
    alg.global_params(state)     -> deployable model
    alg.uplink_vectors / downlink_vectors  -> d-dim vectors communicated per
                                              round per client

``batches`` leaves have leading dims ``(n_clients, tau, ...)`` exactly as in
:mod:`repro_torch.core.algorithm`: the ``tau`` local steps are a Python loop
and the per-client gradients one ``torch.func.vmap``.

  * FedMid    [Yuan et al. 2021]: local proximal SGD + primal averaging.
  * FedDA     [Yuan et al. 2021]: local dual averaging; Algorithm 1 without
    the drift correction (same eta / eta_g), so it coincides with DProx at
    tau = 1.
  * FastFedDA [Bao et al. 2022]: weighted gradient memory and decaying
    steps, two uplink vectors.  Its step size is a float32 scalar, as in
    the reference.
  * Scaffold  [Karimireddy et al. 2020]: control variates, 2 uplink + 2
    downlink vectors, the prox applied at the server (heuristic).
  * FedAvg    [McMahan et al. 2017]: local SGD on f only.
  * FedProx   [Li et al. 2020]: local proximal-point term mu/2 ||z - x||^2.

No baseline takes the fused local-update kernel (its prox runs through
``reg.prox``), and none takes an active-client mask: the engine refuses
partial participation for them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.prox import Regularizer
from repro_torch.device import device_of, to_device
from repro_torch.obs import trace as _trace
from repro_torch.utils import tree as tu

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
        """One full round: the dense composition of the two halves, each in
        its engine span (``exec/local``, ``exec/server``)."""
        local_fn = self.make_local_fn(grad_fn)
        server_fn = self.make_server_fn()

        def round_fn(state, batches):
            with _trace.span("exec/local", "exec", device=True):
                msg, aux = local_fn(state, batches)
            with _trace.span("exec/server", "exec", device=True):
                return server_fn(state, msg, aux)

        return round_fn

    def state_roles(self) -> dict:
        """Placement role per state field: 'server' | 'client' | 'scalar'."""
        raise NotImplementedError

    def global_params(self, state) -> Params:
        raise NotImplementedError


# ---------------------------------------------------------------------------


def _traced_vgrad(grad_fn):
    """``vmap(grad_fn)`` over the clients, each call in a ``local/grad``
    span."""
    vgrad = torch.func.vmap(grad_fn)

    def traced(params, batch):
        with _trace.span("local/grad", "local", device=True):
            return vgrad(params, batch)

    return traced


def _client_axis(batches) -> int:
    return tu.tree_leaves(batches)[0].shape[0]


def _local_loop(state_ref, batches, tau: int, body, carry):
    """The ``tau`` local steps: ``carry = body(carry, t, batch_t)`` with
    ``batch_t`` the clients' batches of step ``t``; returns the last carry
    and the per-client float32 loss summed over the steps.  ``body``
    returns ``(carry, losses)``."""
    n = _client_axis(batches)
    loss_sum = torch.zeros((n,), dtype=torch.float32,
                           device=device_of(state_ref))
    for t in range(tau):
        batch_t = tu.tree_map(lambda x: x[:, t], batches)
        carry, losses = body(carry, t, batch_t)
        loss_sum = loss_sum + losses.to(torch.float32)
    return carry, loss_sum


class _XState(NamedTuple):
    x: Params
    round: torch.Tensor


_X_STATE_ROLES = {"x": "server", "round": "scalar"}


def _zero_round(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device_of(params))


def _innovation(z_stacked, ref):
    """Uplink delta of per-client iterates against the broadcast reference."""
    return tu.tree_map(lambda z, r: z - r[None], z_stacked, ref)


def _base_aux(state, loss_sum, n_clients, **extra):
    """Client-resident aux: per-client loss + the report-round tag."""
    return {"loss_sum": loss_sum, "round": state.round.expand(n_clients),
            **extra}


def _train_loss(aux, tau: int):
    return {"train_loss": torch.mean(aux["loss_sum"]) / tau}


def _x_state_server_fn(eta_g: float, tau: int):
    """Shared server half of the single-vector x-state algorithms
    (FedAvg/FedMid/FedProx):  x+ = x + eta_g * mean_i delta_i."""

    def server_fn(state, msg, aux):
        mean_delta = tu.tree_mean_over_axis0(msg)
        x_next = tu.tree_map(lambda x, md: x + eta_g * md, state.x,
                             mean_delta)
        return _XState(x_next, state.round + 1), _train_loss(aux, tau)

    return server_fn


def _x_local_fn(alg, grad_fn, step):
    """Local half of the x-state algorithms: ``tau`` steps
    ``z = step(z, grads, x)`` from the broadcast ``x``; uplinks
    ``z_tau - x``."""
    vgrad = _traced_vgrad(grad_fn)

    def local_fn(state, batches):
        batches = to_device(batches, device_of(state.x))
        n = _client_axis(batches)

        def body(z, t, batch_t):
            losses, grads = vgrad(z, batch_t)
            return step(z, grads, state.x), losses

        z_tau, loss_sum = _local_loop(state.x, batches, alg.tau, body,
                                      tu.tree_broadcast_axis0(state.x, n))
        return _innovation(z_tau, state.x), _base_aux(state, loss_sum, n)

    return local_fn


class _XAlgorithm(FedAlgorithm):
    """The x-state algorithms' shared state, server half and roles."""

    def init(self, params0, n_clients):
        return _XState(x=params0, round=_zero_round(params0))

    def make_server_fn(self):
        return _x_state_server_fn(self.eta_g, self.tau)

    def state_roles(self):
        return _X_STATE_ROLES

    def global_params(self, state):
        return state.x


@dataclass
class FedAvg(_XAlgorithm):
    """Local SGD on f only; plain averaging.  The smooth-FL reference point."""

    tau: int
    eta: float
    eta_g: float = 1.0
    name: str = "fedavg"

    def make_local_fn(self, grad_fn):
        return _x_local_fn(self, grad_fn, lambda z, g, x: tu.tree_map(
            lambda zi, gi: zi - self.eta * gi, z, g))


@dataclass
class FedMid(_XAlgorithm):
    """Federated mirror descent: local proximal SGD + primal averaging."""

    reg: Regularizer
    tau: int
    eta: float
    eta_g: float = 1.0
    name: str = "fedmid"

    def make_local_fn(self, grad_fn):
        def step(z, grads, x):
            z = tu.tree_map(lambda zi, g: zi - self.eta * g, z, grads)
            return self.reg.prox(z, self.eta)  # prox INSIDE the local loop

        # the server's primal averaging of post-proximal models is the step
        # that destroys sparsity ("curse of primal averaging")
        return _x_local_fn(self, grad_fn, step)


@dataclass
class FedProx(_XAlgorithm):
    """FedProx: local objective f_i(z) + mu/2 ||z - x||^2, prox-SGD steps."""

    reg: Regularizer
    tau: int
    eta: float
    mu: float = 0.1
    eta_g: float = 1.0
    name: str = "fedprox"

    def make_local_fn(self, grad_fn):
        def step(z, grads, x):
            z = tu.tree_map(
                lambda zi, g, xx: zi - self.eta * (g + self.mu
                                                   * (zi - xx[None])),
                z, grads, x)
            return self.reg.prox(z, self.eta)

        return _x_local_fn(self, grad_fn, step)


class _DualState(NamedTuple):
    x_bar: Params  # pre-proximal (dual) global model
    round: torch.Tensor


@dataclass
class FedDA(FedAlgorithm):
    """Federated dual averaging, configured as in the paper's experiments.

    Algorithm 1 with the correction term forced to zero: local updates
    accumulate gradients in the pre-proximal (dual) iterate, the server
    averages pre-proximal models and applies the prox.  Coincides with
    DProx at tau = 1; drifts for tau > 1 under heterogeneity (Fig. 2 right).
    """

    reg: Regularizer
    tau: int
    eta: float
    eta_g: float
    name: str = "fedda"

    @property
    def eta_tilde(self):
        return self.eta * self.eta_g * self.tau

    def init(self, params0, n_clients):
        return _DualState(x_bar=params0, round=_zero_round(params0))

    def make_local_fn(self, grad_fn):
        vgrad = _traced_vgrad(grad_fn)

        def local_fn(state, batches):
            batches = to_device(batches, device_of(state.x_bar))
            n = _client_axis(batches)
            p = self.reg.prox(state.x_bar, self.eta_tilde)
            z_hat0 = tu.tree_broadcast_axis0(p, n)

            def body(carry, t, batch_t):
                z_hat, z = carry
                losses, grads = vgrad(z, batch_t)
                z_hat = tu.tree_map(lambda zh, g: zh - self.eta * g, z_hat,
                                    grads)
                return (z_hat, self.reg.prox(z_hat, (t + 1) * self.eta)), \
                    losses

            (z_hat_tau, _), loss_sum = _local_loop(
                state.x_bar, batches, self.tau, body, (z_hat0, z_hat0))
            return _innovation(z_hat_tau, p), _base_aux(state, loss_sum, n)

        return local_fn

    def make_server_fn(self):
        def server_fn(state, msg, aux):
            p = self.reg.prox(state.x_bar, self.eta_tilde)
            mean_delta = tu.tree_mean_over_axis0(msg)
            x_bar_next = tu.tree_map(lambda pp, md: pp + self.eta_g * md, p,
                                     mean_delta)
            return (_DualState(x_bar_next, state.round + 1),
                    _train_loss(aux, self.tau))

        return server_fn

    def state_roles(self):
        return {"x_bar": "server", "round": "scalar"}

    def global_params(self, state):
        return self.reg.prox(state.x_bar, self.eta_tilde)


class _FastDAState(NamedTuple):
    x_bar: Params
    grad_mem: Params  # weighted gradient memory (server aggregated)
    round: torch.Tensor


@dataclass
class FastFedDA(FedAlgorithm):
    """Fast-FedDA: weighted dual averaging with decaying steps, 2x uplink."""

    reg: Regularizer
    tau: int
    eta0: float
    eta_g: float = 1.0
    name: str = "fast_fedda"
    uplink_vectors: int = 2

    def init(self, params0, n_clients):
        return _FastDAState(x_bar=params0,
                            grad_mem=tu.tree_zeros_like(params0),
                            round=_zero_round(params0))

    def step_size(self, round_, t: int) -> torch.Tensor:
        """eta0 / sqrt(k + 1) at the global step index k = round * tau + t:
        a float32 scalar on the round counter's device, as in the
        reference.  The square root and the quotient are the correctly
        rounded float32 results: each is taken in float64 and rounded once
        to float32 (torch's float32 sqrt on the CPU is not correctly
        rounded, and a division by a 0-dim CPU tensor multiplies by its
        reciprocal)."""
        k1 = round_.to(torch.float64) * self.tau + (t + 1.0)  # exact
        root = torch.sqrt(k1).to(torch.float32)
        eta0 = float(np.float32(self.eta0))
        return (torch.tensor(eta0, dtype=torch.float64, device=round_.device)
                / root.to(torch.float64)).to(torch.float32)

    def make_local_fn(self, grad_fn):
        vgrad = _traced_vgrad(grad_fn)

        def local_fn(state, batches):
            batches = to_device(batches, device_of(state.x_bar))
            n = _client_axis(batches)
            p = self.reg.prox(state.x_bar, self.eta0 * self.tau)
            z_hat0 = tu.tree_broadcast_axis0(p, n)
            mem0 = tu.tree_broadcast_axis0(state.grad_mem, n)

            def body(carry, t, batch_t):
                z_hat, z, mem = carry
                eta_k = self.step_size(state.round, t)  # decaying step
                losses, grads = vgrad(z, batch_t)
                # weighted gradient memory: past gradients keep contributing
                mem = tu.tree_map(lambda m, g: 0.5 * m + 0.5 * g, mem, grads)
                z_hat = tu.tree_map(lambda zh, m: zh - eta_k * m, z_hat, mem)
                z = self.reg.prox(z_hat, (t + 1) * self.eta0)
                return (z_hat, z, mem), losses

            (z_hat_tau, _, mem_tau), loss_sum = _local_loop(
                state.x_bar, batches, self.tau, body, (z_hat0, z_hat0, mem0))
            # TWO uplink vectors per client: the model innovation AND the
            # gradient-memory innovation
            msg = {"z_hat": _innovation(z_hat_tau, p),
                   "mem": _innovation(mem_tau, state.grad_mem)}
            return msg, _base_aux(state, loss_sum, n)

        return local_fn

    def make_server_fn(self):
        def server_fn(state, msg, aux):
            p = self.reg.prox(state.x_bar, self.eta0 * self.tau)
            mean_delta = tu.tree_mean_over_axis0(msg["z_hat"])
            x_bar_next = tu.tree_map(lambda pp, md: pp + self.eta_g * md, p,
                                     mean_delta)
            mem_next = tu.tree_map(lambda gm, md: gm + md, state.grad_mem,
                                   tu.tree_mean_over_axis0(msg["mem"]))
            return (_FastDAState(x_bar_next, mem_next, state.round + 1),
                    _train_loss(aux, self.tau))

        return server_fn

    def state_roles(self):
        return {"x_bar": "server", "grad_mem": "server", "round": "scalar"}

    def global_params(self, state):
        return self.reg.prox(state.x_bar, self.eta0 * self.tau)


class _ScaffoldState(NamedTuple):
    x: Params
    c: Params  # server control variate
    ci: Params  # per-client control variates (leading client axis)
    round: torch.Tensor


@dataclass
class Scaffold(FedAlgorithm):
    """Scaffold with server-side prox as the composite extension (heuristic).

    Communicates the model delta AND the control-variate delta: 2 uplink and
    2 downlink d-dim vectors per round.
    """

    reg: Regularizer
    tau: int
    eta: float
    eta_g: float = 1.0
    name: str = "scaffold"
    uplink_vectors: int = 2
    downlink_vectors: int = 2

    def init(self, params0, n_clients):
        z = tu.tree_zeros_like(params0)
        return _ScaffoldState(x=params0, c=z,
                              ci=tu.tree_map(lambda l: l[None].repeat(
                                  (n_clients,) + (1,) * l.ndim), z),
                              round=_zero_round(params0))

    def make_local_fn(self, grad_fn):
        vgrad = _traced_vgrad(grad_fn)

        def local_fn(state, batches):
            batches = to_device(batches, device_of(state.x))
            n = _client_axis(batches)

            def body(y, t, batch_t):
                losses, grads = vgrad(y, batch_t)
                y = tu.tree_map(
                    lambda yi, g, cii, cc: yi - self.eta * (g - cii
                                                            + cc[None]),
                    y, grads, state.ci, state.c)
                return y, losses

            y_tau, loss_sum = _local_loop(state.x, batches, self.tau, body,
                                          tu.tree_broadcast_axis0(state.x, n))
            # ci+ = ci - c + (x - y_tau)/(tau*eta)   (Scaffold option II)
            ci_next = tu.tree_map(
                lambda cii, cc, x, y: cii - cc[None]
                + (x[None] - y) / (self.tau * self.eta),
                state.ci, state.c, state.x, y_tau)
            # TWO uplink vectors: the model delta and the control-variate
            # delta.  The client keeps its exact ci_next in aux; the
            # server's c integrates the uplinked deltas (c == mean_i ci).
            msg = {"y": _innovation(y_tau, state.x),
                   "ci": tu.tree_map(lambda cn, co: cn - co, ci_next,
                                     state.ci)}
            return msg, _base_aux(state, loss_sum, n, ci=ci_next)

        return local_fn

    def make_server_fn(self):
        def server_fn(state, msg, aux):
            mean_dy = tu.tree_mean_over_axis0(msg["y"])
            x_next = tu.tree_map(lambda x, md: x + self.eta_g * md, state.x,
                                 mean_dy)
            x_next = self.reg.prox(x_next, self.eta * self.tau)
            c_next = tu.tree_map(lambda c, md: c + md, state.c,
                                 tu.tree_mean_over_axis0(msg["ci"]))
            return (_ScaffoldState(x_next, c_next, aux["ci"],
                                   state.round + 1),
                    _train_loss(aux, self.tau))

        return server_fn

    def state_roles(self):
        return {"x": "server", "c": "server", "ci": "client",
                "round": "scalar"}

    def global_params(self, state):
        return state.x
