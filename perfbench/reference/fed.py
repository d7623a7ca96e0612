"""Federated rounds in plain PyTorch, one client at a time: Algorithm 1 of
arXiv:2502.03958 (DProx) and FedDA with an L1 regularizer, and a global
top-k uplink compressor with error feedback.

DProx, round r with p = soft(x_bar, eta*eta_g*tau*lam) and, per client i,
z_hat = z = p:

    for t < tau:  g = grad f_i(z; batch_t)
                  z_hat = z_hat - eta * (g + c_i);  z = soft(z_hat, (t+1)*eta*lam)
    m_i = z_hat - p   [top-k: e_i + m_i kept where |.| reaches its k-th
                       largest magnitude over the client's whole vector;
                       e_i keeps the rest]
    x_bar' = p + eta_g * mean_i m_i
    c_i'   = (p - x_bar') / (eta_g*eta*tau) - mean_t g

FedDA is the same with c = 0 (no correction term).

:func:`run` returns what the benchmark compares: the train loss of every
round (the mean over clients of the mean over local steps), the first
round's gradient as the server state keeps it (DProx: each client's mean
gradient, stacked; FedDA: their mean), and the change of ``x_bar`` after
the last round, each as one norm a leaf (float64).
"""
from __future__ import annotations

import torch


def soft(x, t: float):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def k_of(ratio: float, d: int) -> int:
    """Coordinates kept of ``d`` (Python's round: ties to even)."""
    return max(1, min(d, int(round(ratio * d))))


def topk_global(target: dict, ratio: float) -> dict:
    """One client's message with only its largest magnitudes kept: every
    coordinate whose magnitude reaches the k-th largest over all leaves."""
    mags = torch.cat([v.reshape(-1).abs() for v in target.values()])
    kth = torch.topk(mags, k_of(ratio, mags.numel())).values[-1]
    del mags
    return {k: torch.where(v.abs() >= kth, v, torch.zeros_like(v))
            for k, v in target.items()}


def _batch(batches: dict, i: int, t: int) -> dict:
    return {k: v[i, t] for k, v in batches.items()}


def run(alg: dict, params0: dict, loss_and_grad, batches: list) -> dict:
    """``alg``: ``algorithm`` (dprox | fedda), ``tau``, ``eta``, ``eta_g``,
    ``lam``, ``clients`` and ``transport`` (None, or ``{"name": "topk",
    "ratio": r}``); ``params0``: path -> tensor; ``batches``: one dict a
    round of arrays shaped (clients, tau, ...)."""
    tau, eta, eta_g, lam = alg["tau"], alg["eta"], alg["eta_g"], alg["lam"]
    n = alg["clients"]
    dprox = alg["algorithm"] == "dprox"
    if alg["algorithm"] not in ("dprox", "fedda"):
        raise ValueError(alg["algorithm"])
    tr = alg.get("transport")
    if tr is not None and tr["name"] != "topk":
        raise ValueError(f"transport {tr['name']!r}")
    scale = 1.0 / (eta_g * eta * tau)
    x_bar = {k: v.clone() for k, v in params0.items()}
    # per client: the correction term (DProx) or nothing; the top-k
    # residual; and, between a client's turn and the server's step, its
    # mean gradient (it takes the correction term's place)
    c = ([{k: torch.zeros_like(v) for k, v in x_bar.items()}
          for _ in range(n)] if dprox else None)
    resid = ([{k: torch.zeros_like(v) for k, v in x_bar.items()}
              for _ in range(n)] if tr is not None else None)
    losses, grad1 = [], None
    for rnd, batch in enumerate(batches):
        p = {k: soft(v, eta * eta_g * tau * lam) for k, v in x_bar.items()}
        msg_sum = {k: torch.zeros_like(v) for k, v in p.items()}
        avg = [] if not dprox else None
        loss_sum = 0.0
        for i in range(n):
            z_hat = {k: v.clone() for k, v in p.items()}
            z = p
            gsum = {k: torch.zeros_like(v) for k, v in p.items()}
            client_loss = 0.0
            for t in range(tau):
                value, g = loss_and_grad(z, _batch(batch, i, t))
                client_loss += float(value)
                for k in z_hat:
                    step = g[k] + c[i][k] if dprox else g[k]
                    z_hat[k] -= eta * step
                    gsum[k] += g[k]
                z = {k: soft(v, (t + 1) * eta * lam) for k, v in z_hat.items()}
                del g
            loss_sum += client_loss / tau
            msg = {k: z_hat[k] - p[k] for k in p}
            del z_hat, z
            if tr is not None:
                target = {k: resid[i][k] + msg[k] for k in msg}
                msg = topk_global(target, tr["ratio"])
                resid[i] = {k: target[k] - msg[k] for k in msg}
                del target
            for k in msg:
                msg_sum[k] += msg[k]
            del msg
            mean_g = {k: v / tau for k, v in gsum.items()}
            if dprox:
                c[i] = mean_g
            else:
                avg.append(mean_g)
        x_bar = {k: p[k] + eta_g * (msg_sum[k] / n) for k in p}
        del msg_sum
        if dprox:
            if rnd == 0:
                grad1 = {k: norm(torch.stack([c[i][k] for i in range(n)]))
                         for k in p}
            for i in range(n):
                c[i] = {k: scale * (p[k] - x_bar[k]) - c[i][k] for k in p}
        elif rnd == 0:
            grad1 = {k: norm(sum(a[k] for a in avg) / n) for k in p}
        del p, avg
        losses.append(loss_sum / n)
    return {"loss": losses, "grad1": grad1,
            "dx": {k: norm(x_bar[k] - params0[k]) for k in params0}}


def array_supplier_batches(arrays: dict, tau: int, batch: int, seed: int,
                           rounds: int) -> list:
    """The batches of rounds ``0 .. rounds-1`` that an i.i.d. minibatch
    supplier over equal-sized per-client arrays (clients, examples, ...)
    draws: for round r, indices ``numpy.random.default_rng((seed, r))
    .integers(0, examples, (clients, tau, batch))``, with replacement."""
    import numpy as np

    out = []
    first = next(iter(arrays.values()))
    n, m = first.shape[:2]
    for r in range(rounds):
        idx = np.random.default_rng((seed, r)).integers(0, m, size=(n, tau, batch))
        rows = np.arange(n)[:, None, None]
        out.append({k: v[rows, idx] for k, v in arrays.items()})
    return out
