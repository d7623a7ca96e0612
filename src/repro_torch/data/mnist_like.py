"""Synthetic MNIST-like dataset + the paper's heterogeneous federated split.

The port's own copy of the numpy code in :mod:`repro.data.mnist_like`: the
same seed gives byte-identical arrays.

A procedural 10-class 28x28 grayscale dataset with MNIST-like statistics
stands in for MNIST (the repository runs offline): each class is a smooth
random "stroke template" (random-walk strokes blurred into a pen-like
pattern), rendered with a per-sample random shift, row-swap jitter,
intensity scaling and pixel noise.

The federated split follows Section 4.2: half the samples are distributed
uniformly at random across the 10 clients, the other half are assigned
label l -> client l, so every client sees all classes but is dominated by
one -- label skew.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _smooth(img, passes=2):
    for _ in range(passes):
        img = (
            img
            + np.roll(img, 1, 0) + np.roll(img, -1, 0)
            + np.roll(img, 1, 1) + np.roll(img, -1, 1)
        ) / 5.0
    return img


def _class_template(rng, size=28):
    """Random stroke pattern: a few connected random walks, blurred."""
    img = np.zeros((size, size), np.float32)
    n_strokes = rng.integers(2, 4)
    for _ in range(n_strokes):
        x, y = rng.integers(6, size - 6, size=2).astype(float)
        dx, dy = rng.normal(size=2)
        for _ in range(rng.integers(15, 30)):
            xi, yi = int(np.clip(x, 1, size - 2)), int(np.clip(y, 1, size - 2))
            img[xi - 1 : xi + 2, yi - 1 : yi + 2] += 0.5
            dx, dy = 0.8 * dx + 0.6 * rng.normal(), 0.8 * dy + 0.6 * rng.normal()
            nrm = max(np.hypot(dx, dy), 1e-6)
            x += 1.5 * dx / nrm
            y += 1.5 * dy / nrm
    img = _smooth(img, 2)
    return np.clip(img / max(img.max(), 1e-6), 0, 1)


def generate(n_train=30000 * 2, n_test=10000, seed=0):
    """Returns (train_x, train_y, test_x, test_y); x in [0,1], NHWC."""
    rng = np.random.default_rng(seed)
    templates = [_class_template(rng) for _ in range(10)]

    def render(cls, n):
        t = templates[cls]
        out = np.zeros((n, 28, 28, 1), np.float32)
        shifts = rng.integers(-3, 4, size=(n, 2))
        scales = rng.uniform(0.7, 1.3, size=n)
        for i in range(n):
            img = np.roll(t, shifts[i], axis=(0, 1)) * scales[i]
            img = img + rng.normal(0, 0.15, size=(28, 28))
            # light elastic jitter: swap a couple of random rows/cols
            if rng.uniform() < 0.5:
                r = rng.integers(1, 27)
                img[[r, r - 1]] = img[[r - 1, r]]
            out[i, :, :, 0] = np.clip(img, 0, 1)
        return out

    def make_split(n):
        per = n // 10
        xs, ys = [], []
        for c in range(10):
            xs.append(render(c, per))
            ys.append(np.full(per, c, np.int32))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        perm = rng.permutation(len(y))
        return x[perm], y[perm]

    train_x, train_y = make_split(n_train)
    test_x, test_y = make_split(n_test)
    return train_x, train_y, test_x, test_y


@dataclass
class FederatedImageData:
    client_x: list  # per-client arrays (m_i, 28, 28, 1)
    client_y: list
    test_x: np.ndarray
    test_y: np.ndarray

    @property
    def n_clients(self):
        return len(self.client_x)


def heterogeneous_split(train_x, train_y, test_x, test_y, n_clients=10,
                        seed=0) -> FederatedImageData:
    """Section 4.2 split: half uniform, half label-l -> client l+1."""
    rng = np.random.default_rng(seed)
    n = len(train_y)
    half = n // 2
    perm = rng.permutation(n)
    uni_idx, skew_idx = perm[:half], perm[half:]
    client_idx = [[] for _ in range(n_clients)]
    # uniform half
    for j, i in enumerate(uni_idx):
        client_idx[j % n_clients].append(i)
    # label-skew half: label l goes to client l (mod n_clients)
    for i in skew_idx:
        client_idx[int(train_y[i]) % n_clients].append(i)
    cx = [train_x[np.array(ix)] for ix in client_idx]
    cy = [train_y[np.array(ix)] for ix in client_idx]
    return FederatedImageData(cx, cy, test_x, test_y)


def sample_round_batches(data: FederatedImageData, tau: int, b: int,
                         rng: np.random.Generator):
    """{"x": (n, tau, b, 28,28,1), "y": (n, tau, b)} -- note m_i differ per
    client, so indices are drawn per client."""
    n = data.n_clients
    xs = np.zeros((n, tau, b, 28, 28, 1), np.float32)
    ys = np.zeros((n, tau, b), np.int32)
    for i in range(n):
        m = len(data.client_y[i])
        idx = rng.integers(0, m, size=(tau, b))
        xs[i] = data.client_x[i][idx]
        ys[i] = data.client_y[i][idx]
    return {"x": xs, "y": ys}
