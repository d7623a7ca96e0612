"""Heterogeneous synthetic data generators (numpy).

The port's own copy of the numpy code in :mod:`repro.data.synthetic`: the
same seed gives byte-identical arrays.

``logistic_heterogeneous`` follows the generator of Li et al. (FedProx, 2020)
that the paper uses for the sparse-logistic-regression experiments: two
parameters (alpha, beta) control how much the local models and the local
feature distributions differ across clients.  The paper uses
(alpha, beta) = (50, 50), n = 30 clients, d = 20.
``token_stream_heterogeneous`` makes the LM trainer's per-client token
streams (``repro_torch.launch.train``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FederatedDataset:
    """Per-client arrays, leading axis = client."""

    features: np.ndarray  # (n_clients, m, d)
    labels: np.ndarray  # (n_clients, m)  (+/-1 for binary)
    n_clients: int

    def client(self, i):
        return self.features[i], self.labels[i]


def logistic_heterogeneous(
    n_clients: int = 30,
    m_per_client: int = 100,
    d: int = 20,
    alpha: float = 50.0,
    beta: float = 50.0,
    seed: int = 0,
    binary: bool = True,
) -> FederatedDataset:
    """Li et al. (alpha, beta)-heterogeneous synthetic logistic data.

    Client i draws a local ground-truth weight  W_i ~ N(u_i, 1), u_i ~ N(0, alpha)
    and local feature mean  v_i ~ N(B_i, 1), B_i ~ N(0, beta); features have a
    decaying diagonal covariance Sigma_kk = k^{-1.2}.  Labels are the sign of
    the local linear model -- so both the "true" models and the marginals
    differ across clients.
    """
    rng = np.random.default_rng(seed)
    cov_diag = np.array([(k + 1) ** (-1.2) for k in range(d)])
    feats = np.zeros((n_clients, m_per_client, d), np.float32)
    labels = np.zeros((n_clients, m_per_client), np.float32)
    for i in range(n_clients):
        u_i = rng.normal(0.0, np.sqrt(alpha))
        b_i = rng.normal(0.0, np.sqrt(beta))
        w_i = rng.normal(u_i, 1.0, size=(d,))
        bias_i = rng.normal(u_i, 1.0)
        v_i = rng.normal(b_i, 1.0, size=(d,))
        x = rng.normal(v_i, np.sqrt(cov_diag), size=(m_per_client, d))
        logits = x @ w_i + bias_i
        p = 1.0 / (1.0 + np.exp(-logits))
        y = np.where(rng.uniform(size=m_per_client) < p, 1.0, -1.0)
        feats[i] = x.astype(np.float32)
        labels[i] = y.astype(np.float32)
    return FederatedDataset(features=feats, labels=labels, n_clients=n_clients)


def make_round_batches(
    data: FederatedDataset,
    tau: int,
    batch_size: int | None,
    rng: np.random.Generator,
):
    """Sample one round of client mini-batches.

    Returns a dict of arrays with leading dims (n_clients, tau, b, ...).
    ``batch_size=None`` means full local gradients (the paper's Fig. 2 mode):
    every local step sees the whole local dataset.
    """
    n, m, d = data.features.shape
    if batch_size is None:
        a = np.broadcast_to(data.features[:, None], (n, tau, m, d))
        y = np.broadcast_to(data.labels[:, None], (n, tau, m))
        return {"a": np.ascontiguousarray(a), "y": np.ascontiguousarray(y)}
    idx = rng.integers(0, m, size=(n, tau, batch_size))
    a = np.take_along_axis(
        data.features[:, None], idx[..., None], axis=2
    )  # (n, tau, b, d)
    y = np.take_along_axis(data.labels[:, None], idx, axis=2)
    return {"a": a, "y": y}


def token_stream_heterogeneous(
    n_clients: int,
    seq_len: int,
    n_seqs_per_client: int,
    vocab: int,
    seed: int = 0,
    skew: float = 4.0,
) -> np.ndarray:
    """Per-client token sequences from client-specific bigram chains.

    Each client gets its own random bigram transition matrix sharpened by
    ``skew`` (higher = more deterministic = more heterogeneous), so local
    next-token distributions genuinely differ.  Returns int32 array of shape
    (n_clients, n_seqs_per_client, seq_len).
    """
    rng = np.random.default_rng(seed)
    out = np.zeros((n_clients, n_seqs_per_client, seq_len), np.int32)
    for i in range(n_clients):
        logits = rng.normal(size=(vocab, vocab)) * skew
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        cdf = np.cumsum(probs, axis=1)
        for s in range(n_seqs_per_client):
            tok = int(rng.integers(vocab))
            seq = np.empty(seq_len, np.int32)
            u = rng.uniform(size=seq_len)
            for t in range(seq_len):
                seq[t] = tok
                tok = int(np.searchsorted(cdf[tok], u[t]))
                tok = min(tok, vocab - 1)
            out[i, s] = seq
    return out
