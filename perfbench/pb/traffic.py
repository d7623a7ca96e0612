"""The one generator every traffic file is read by: the clients' data,
made on the host from ``--seed``.

``"data": "token_streams"`` -- per-client sequences from client-specific
bigram chains (each client its own random transition matrix sharpened by
``skew``, so local next-token distributions differ), token ids below
``min(vocab, vocab_cap)``: ``(clients, seqs_per_client, seq)`` int32.

``"data": "images"`` -- a procedural 10-class 28x28 image set with
MNIST-like statistics (smooth random stroke templates, each sample shifted,
scaled, row-jittered and noised), ``train_images`` of them, split as
Section 4.2 of arXiv:2502.03958: half uniformly over the clients, half
label l -> client l, so each client sees every class but one dominates.

Both are copies of the program's own generators (``data/synthetic.py``
``token_stream_heterogeneous`` and ``data/mnist_like.py``), kept here so
the benchmark's inputs cannot change with the program.
"""
from __future__ import annotations

import numpy as np


def token_streams(n_clients: int, seq_len: int, n_seqs: int, vocab: int,
                  seed: int, skew: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.zeros((n_clients, n_seqs, seq_len), np.int32)
    for i in range(n_clients):
        logits = rng.normal(size=(vocab, vocab)) * skew
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        cdf = np.cumsum(probs, axis=1)
        for s in range(n_seqs):
            tok = int(rng.integers(vocab))
            u = rng.uniform(size=seq_len)
            for t in range(seq_len):
                out[i, s, t] = tok
                tok = min(int(np.searchsorted(cdf[tok], u[t])), vocab - 1)
    return out


def _smooth(img, passes=2):
    for _ in range(passes):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    return img


def _template(rng, size=28):
    img = np.zeros((size, size), np.float32)
    for _ in range(rng.integers(2, 4)):
        x, y = rng.integers(6, size - 6, size=2).astype(float)
        dx, dy = rng.normal(size=2)
        for _ in range(rng.integers(15, 30)):
            xi = int(np.clip(x, 1, size - 2))
            yi = int(np.clip(y, 1, size - 2))
            img[xi - 1:xi + 2, yi - 1:yi + 2] += 0.5
            dx = 0.8 * dx + 0.6 * rng.normal()
            dy = 0.8 * dy + 0.6 * rng.normal()
            nrm = max(np.hypot(dx, dy), 1e-6)
            x += 1.5 * dx / nrm
            y += 1.5 * dy / nrm
    img = _smooth(img, 2)
    return np.clip(img / max(img.max(), 1e-6), 0, 1)


def images(n: int, seed: int):
    """(x (n, 28, 28, 1) float32 in [0, 1], y (n,) int32), 10 classes of
    n // 10 each, shuffled."""
    rng = np.random.default_rng(seed)
    templates = [_template(rng) for _ in range(10)]
    per = n // 10
    xs = np.zeros((10 * per, 28, 28, 1), np.float32)
    ys = np.repeat(np.arange(10, dtype=np.int32), per)
    for c in range(10):
        shifts = rng.integers(-3, 4, size=(per, 2))
        scales = rng.uniform(0.7, 1.3, size=per)
        for j in range(per):
            img = np.roll(templates[c], shifts[j], axis=(0, 1)) * scales[j]
            img = img + rng.normal(0, 0.15, size=(28, 28))
            if rng.uniform() < 0.5:
                r = rng.integers(1, 27)
                img[[r, r - 1]] = img[[r - 1, r]]
            xs[c * per + j, :, :, 0] = np.clip(img, 0, 1)
    perm = rng.permutation(len(ys))
    return xs[perm], ys[perm]


def label_skew_split(x, y, n_clients: int, seed: int):
    """Per-client (x_i, y_i): half the samples dealt round-robin in a
    random order, the other half sample -> client (label mod n)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(y))
    half = len(y) // 2
    idx = [[] for _ in range(n_clients)]
    for j, i in enumerate(perm[:half]):
        idx[j % n_clients].append(i)
    for i in perm[half:]:
        idx[int(y[i]) % n_clients].append(i)
    return [(x[np.array(ix)], y[np.array(ix)]) for ix in idx]


def make(traffic: dict, config: dict, seed: int):
    """The clients' data for ``traffic``: token streams (an array) or the
    per-client image sets (a list of (x, y))."""
    kind = traffic["data"]
    if kind == "token_streams":
        return token_streams(traffic["clients"], traffic["seq"],
                             traffic["seqs_per_client"],
                             min(config["vocab"], traffic["vocab_cap"]),
                             seed, traffic["skew"])
    if kind == "images":
        x, y = images(traffic["train_images"], seed)
        return label_skew_split(x, y, traffic["clients"], seed)
    raise ValueError(f"unknown traffic data {kind!r}")
