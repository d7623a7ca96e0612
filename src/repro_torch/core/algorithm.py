"""Algorithm 1 of Zhang, Hu & Johansson (2025), in PyTorch:

    "Non-convex composite federated learning with heterogeneous data"

The counterpart of :mod:`repro.core.algorithm`.  The algorithm solves
min_x  F(x) = (1/n) sum_i f_i(x) + g(x)  with decoupled proximal evaluation
and communication, ``tau`` local steps per round, a client-drift correction
``c_i`` rebuilt locally from the broadcast pre-proximal model, and the
(t+1)*eta proximal schedule during local steps.

Two equivalent implementations, as in the reference:

  * :func:`make_round_fn` -- the compact form (Eq. 2): all clients stacked on
    a leading axis, the ``tau`` local steps a Python loop, the per-client
    gradients one ``torch.func.vmap``;
  * :func:`client_local_round` / :func:`server_update` /
    :func:`client_correction_update` -- the literal per-client protocol.

The local step (Lines 9-10) for an unmasked L1 regularizer always goes
through :func:`repro_torch.kernels.ops.fused_local_update`: the Hopper kernel
on CUDA tensors, its plain version on CPU tensors, one launch per step for
all clients.  Its threshold follows ``prox_schedule``.  A masked L1 or any
other regularizer takes ``reg.prox``.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.prox import L1, Regularizer
from repro_torch.device import device_of, to_device
from repro_torch.kernels import ops as kops
from repro_torch.obs import trace as _trace
from repro_torch.utils import tree as tu

Params = Any
Batch = Any
# grad_fn(params, batch) -> (loss, grads)
GradFn = Callable[[Params, Batch], tuple]


@dataclass(frozen=True)
class DProxConfig:
    """Hyper-parameters of Algorithm 1.

    Theorems 3.5/3.6 require  eta_tilde = eta*eta_g*tau <= 1/(10 L)  and
    eta_g >= max(1.5, sqrt(n/8)).  ``validate`` checks the latter.
    """

    tau: int
    eta: float
    eta_g: float
    # "linear": the paper's (t+1)*eta prox parameter (Section 2.2 item 4);
    # "fixed": ablation using eta_tilde at every local step.
    prox_schedule: str = "linear"

    @property
    def eta_tilde(self) -> float:
        return self.eta * self.eta_g * self.tau

    def prox_param(self, t: int) -> float:
        """The prox parameter of local step ``t`` (0-based)."""
        if self.prox_schedule == "linear":
            return (t + 1) * self.eta
        return self.eta_tilde

    def validate(self, n_clients: int) -> None:
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1, got {self.tau}")
        lo = max(1.5, (n_clients / 8.0) ** 0.5)
        if self.eta_g < lo:
            warnings.warn(
                f"eta_g={self.eta_g} < max(1.5, sqrt(n/8))={lo:.3f}: outside "
                "the step-size regime of Theorems 3.5/3.6 (may still work "
                "empirically, as in the paper's hand-tuned experiments).")


class DProxState(NamedTuple):
    """Server + per-client persistent state (a pytree node as it stands:
    ``torch.utils._pytree`` handles ``NamedTuple``s natively).

    ``x_bar`` is the *pre-proximal* global model (what the server
    broadcasts); the deployable global model is ``P_eta_tilde(x_bar)``.
    ``c`` stacks the per-client correction terms on a leading client axis.
    """

    x_bar: Params
    c: Params  # leading axis n_clients
    round: torch.Tensor  # scalar int32


def init_state(params0: Params, n_clients: int) -> DProxState:
    """x_bar^1 = params0,  c_i^1 = 0 (Line 1 of Algorithm 1)."""
    return DProxState(
        x_bar=params0,
        c=tu.tree_broadcast_axis0(tu.tree_zeros_like(params0), n_clients),
        round=torch.zeros((), dtype=torch.int32, device=device_of(params0)),
    )


def global_params(reg: Regularizer, cfg: DProxConfig, state: DProxState) -> Params:
    """The post-proximal global model P_eta_tilde(x_bar) -- Algorithm 1 output."""
    return reg.prox(state.x_bar, cfg.eta_tilde)


def _uses_kernel(reg: Regularizer) -> bool:
    return isinstance(reg, L1) and reg.mask is None


def _step(reg, eta: float, prox_param: float, z_hat, grads, c, batch_dims):
    """Lines 9-10 with prox parameter ``prox_param``."""
    if _uses_kernel(reg):
        return kops.fused_local_update(z_hat, grads, c, eta,
                                       prox_param * reg.lam,
                                       batch_dims=batch_dims)
    z_hat_next = tu.tree_map(lambda zh, g, ci: zh - eta * (g + ci),
                             z_hat, grads, c)
    return z_hat_next, reg.prox(z_hat_next, prox_param)


def local_update_step(reg: Regularizer, eta: float, t: int, z_hat: Params,
                      grads: Params, c: Params):
    """One local update (Lines 9-10): the paper's hot inner loop.

    z_hat_{t+1} = z_hat_t - eta * (grad + c)
    z_{t+1}     = P_{(t+1) eta}(z_hat_{t+1})
    """
    grads = tu.tree_map(lambda g, zh: g.to(zh.dtype), grads, z_hat)
    return _step(reg, eta, (t + 1) * eta, z_hat, grads, c, batch_dims=0)


def make_local_fn(cfg: DProxConfig, reg: Regularizer, grad_fn: GradFn):
    """Client half of the compact-form round (Lines 5-12, clients stacked).

    Returns ``local_fn(state, batches) -> (msg, aux)`` where ``msg`` is the
    per-client *innovation* ``z_hat_tau - P(x_bar)`` (leading client axis),
    the only tensor that crosses the network, and ``aux`` holds
    client-resident values: the average gradient for the correction
    rebuild, the per-client tau-summed loss, and the report-round tag.
    """
    vgrad = torch.func.vmap(grad_fn)

    def local_fn(state: DProxState, batches: Batch):
        device = device_of(state.x_bar)
        batches = to_device(batches, device)
        n_clients = tu.tree_leaves(batches)[0].shape[0]
        p = reg.prox(state.x_bar, cfg.eta_tilde)  # P_eta_tilde(x_bar^r), Line 5
        z_hat = tu.tree_broadcast_axis0(p, n_clients)
        z = z_hat
        gsum = tu.tree_zeros_like(z_hat)
        loss_sum = torch.zeros((n_clients,), dtype=torch.float32,
                               device=device)
        for t in range(cfg.tau):
            batch_t = tu.tree_map(lambda x: x[:, t], batches)
            with _trace.span("local/grad", "local", device=True):
                losses, grads = vgrad(z, batch_t)  # (n,)
            with _trace.span("local/update", "local", device=True):
                # keep the federated state arithmetic in the params dtype
                grads = tu.tree_map(lambda g, zh: g.to(zh.dtype), grads,
                                    z_hat)
                z_hat, z = _step(reg, cfg.eta, cfg.prox_param(t), z_hat,
                                 grads, state.c, batch_dims=1)
                gsum = tu.tree_add(gsum, grads)
                loss_sum = loss_sum + losses.to(torch.float32)
        msg = tu.tree_map(lambda zh, pp: zh - pp[None], z_hat, p)
        aux = {
            "avg_grad": tu.tree_scale(gsum, 1.0 / cfg.tau),  # (n, ...)
            "loss_sum": loss_sum,  # (n,) per-client tau-summed mean loss
            "round": state.round.expand(n_clients),
        }
        return msg, aux

    return local_fn


def make_server_fn(cfg: DProxConfig, reg: Regularizer):
    """Server half (Lines 14-15) plus the local correction rebuild (Line 18).

    ``server_fn(state, msg, aux, active=None, weighted_sum=None) ->
    (state, metrics)``.  ``active``: optional (n_clients,) bool mask --
    partial client participation, and the delivered reports of a buffered
    asynchronous commit: the server averages over them only and the others
    keep their correction terms.  ``weighted_sum(w)``, if given, returns the
    tree ``sum_i w_i * msg_i`` in place of the per-leaf sum over the client
    axis: the plane-mode engine passes one that reduces the whole
    ``(n_clients, d_pad)`` message plane in one commit-kernel launch
    (:func:`repro_torch.kernels.ops.plane_weighted_commit`).
    """

    def server_fn(state: DProxState, msg, aux, active=None,
                  weighted_sum=None):
        delta = msg  # per-client innovations z_hat_tau - P(x_bar)
        p = reg.prox(state.x_bar, cfg.eta_tilde)

        # --- Server (Lines 14-15): x_bar+ = P + eta_g mean_i delta_i
        if active is None:
            mean_delta = tu.tree_mean_over_axis0(delta)
        else:
            active = torch.as_tensor(active, device=device_of(p))
            w = active.to(torch.float32)
            denom = torch.clamp_min(torch.sum(w), 1.0)
            if weighted_sum is None:
                def weighted_sum(w):
                    return tu.tree_map(
                        lambda z: torch.sum(z * w.reshape(
                            (-1,) + (1,) * (z.ndim - 1)).to(z.dtype), dim=0),
                        delta)

            mean_delta = tu.tree_map(lambda s: s / denom.to(s.dtype),
                                     weighted_sum(w))
        x_bar_next = tu.tree_map(lambda pp, md: pp + cfg.eta_g * md, p,
                                 mean_delta)

        # --- Client correction update (Line 18), rebuilt locally from the
        # broadcast x_bar^{r+1}; no extra communication.
        scale = 1.0 / (cfg.eta_g * cfg.eta * cfg.tau)
        c_next = tu.tree_map(lambda pp, xn, ag: scale * (pp - xn)[None] - ag,
                             p, x_bar_next, aux["avg_grad"])
        if active is not None:
            # non-participants keep their stale correction terms
            c_next = tu.tree_map(
                lambda new, old: torch.where(
                    active.reshape((-1,) + (1,) * (new.ndim - 1)), new, old),
                c_next, state.c)

        metrics = {
            "train_loss": torch.mean(aux["loss_sum"]) / cfg.tau,
            # drift is shift-invariant: spread of the innovations
            "drift": tu.tree_norm(tu.tree_map(lambda dl, md: dl - md[None],
                                              delta, mean_delta)),
        }
        new_state = DProxState(x_bar=x_bar_next, c=c_next,
                               round=state.round + 1)
        return new_state, metrics

    return server_fn


def make_round_fn(cfg: DProxConfig, reg: Regularizer, grad_fn: GradFn):
    """The compact-form round function (Eq. 2): the composition of
    :func:`make_local_fn` and :func:`make_server_fn`, each in its engine
    span (``exec/local``, ``exec/server``).

    Returns ``round_fn(state, batches, active=None) -> (state, metrics)``
    where ``batches`` is a pytree whose leaves have leading dims
    ``(n_clients, tau, ...)`` (tensors or numpy arrays).
    """
    local_fn = make_local_fn(cfg, reg, grad_fn)
    server_fn = make_server_fn(cfg, reg)

    def round_fn(state: DProxState, batches: Batch, active=None):
        with _trace.span("exec/local", "exec", device=True):
            msg, aux = local_fn(state, batches)
        with _trace.span("exec/server", "exec", device=True):
            return server_fn(state, msg, aux, active=active)

    return round_fn


# ---------------------------------------------------------------------------
# Literal per-client protocol (Algorithm 1 as message passing).
# ---------------------------------------------------------------------------


def client_local_round(cfg: DProxConfig, reg: Regularizer, grad_fn: GradFn,
                       x_bar: Params, c_i: Params, batches_i: Batch):
    """Lines 5-12 for a single client.

    ``batches_i`` leaves have leading dim ``tau``.  Returns the uplink
    message ``z_hat_tau`` and the locally retained average gradient.
    """
    p = reg.prox(x_bar, cfg.eta_tilde)
    z_hat, z = p, p
    gsum = tu.tree_zeros_like(p)
    for t in range(cfg.tau):
        batch_t = tu.tree_map(lambda x: x[t], batches_i)
        _, grads = grad_fn(z, batch_t)
        z_hat, z = local_update_step(reg, cfg.eta, t, z_hat, grads, c_i)
        gsum = tu.tree_add(gsum, grads)
    avg_grad_i = tu.tree_scale(gsum, 1.0 / cfg.tau)
    return z_hat, avg_grad_i


def server_update(cfg: DProxConfig, reg: Regularizer, x_bar: Params,
                  z_hat_msgs: list) -> Params:
    """Line 14: x_bar^{r+1} = P(x_bar) + eta_g (mean_i z_hat_i - P(x_bar))."""
    p = reg.prox(x_bar, cfg.eta_tilde)
    mean_z_hat = tu.tree_scale(
        tu.tree_map(lambda *xs: sum(xs), *z_hat_msgs), 1.0 / len(z_hat_msgs))
    return tu.tree_map(lambda pp, mz: pp + cfg.eta_g * (mz - pp), p,
                       mean_z_hat)


def client_correction_update(cfg: DProxConfig, reg: Regularizer,
                             x_bar_prev: Params, x_bar_next: Params,
                             avg_grad_i: Params) -> Params:
    """Line 18: rebuild c_i^{r+1} from the broadcast pre-proximal model."""
    p = reg.prox(x_bar_prev, cfg.eta_tilde)
    scale = 1.0 / (cfg.eta_g * cfg.eta * cfg.tau)
    return tu.tree_map(lambda pp, xn, ag: scale * (pp - xn) - ag, p,
                       x_bar_next, avg_grad_i)


def run_per_client_round(cfg: DProxConfig, reg: Regularizer, grad_fn: GradFn,
                         state: DProxState, batches: Batch) -> DProxState:
    """One full round via the literal protocol (Python loop over clients)."""
    batches = to_device(batches, device_of(state.x_bar))
    n_clients = tu.tree_leaves(batches)[0].shape[0]
    msgs, avg_grads = [], []
    for i in range(n_clients):
        batches_i = tu.tree_map(lambda x: x[i], batches)
        c_i = tu.tree_index_axis0(state.c, i)
        z_hat_i, ag_i = client_local_round(cfg, reg, grad_fn, state.x_bar,
                                           c_i, batches_i)
        msgs.append(z_hat_i)
        avg_grads.append(ag_i)
    x_bar_next = server_update(cfg, reg, state.x_bar, msgs)
    cs = [client_correction_update(cfg, reg, state.x_bar, x_bar_next, ag)
          for ag in avg_grads]
    return DProxState(x_bar=x_bar_next, c=tu.tree_stack_axis0(cs),
                      round=state.round + 1)
