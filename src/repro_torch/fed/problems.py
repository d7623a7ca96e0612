"""The paper's problem set-ups.

:func:`logreg_problem` is the port of ``benchmarks/common.py:logreg_problem``
(Section 4.1): sparse logistic regression with an L1 regularizer on the
(alpha, beta)-heterogeneous synthetic data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.prox import L1
from repro_torch.data.synthetic import logistic_heterogeneous
from repro_torch.device import resolve_device
from repro_torch.models import logreg


def smoothness(features: np.ndarray, device, *, bias: bool = False) -> float:
    """L = lambda_max(A^T A) / (4 N) for the logistic loss over all N rows.

    With fewer rows than features the (N x N) Gram matrix A A^T, which has
    the same top eigenvalue, is formed on ``device`` instead: at d = 112,394
    the (d x d) matrix A^T A would take ~100 GB.  Otherwise A^T A is formed
    with numpy, as the reference does, so L is the reference's L.

    ``bias=True`` appends the bias coordinate's column of ones to A, whose
    curvature reaches 1/4; the reference leaves it out.  The Fig. 2 problem
    converges with the reference's L all the same, but at d = 112,394 a
    step of 0.5/L from it does not (ROADMAP Queue 3).
    """
    d = features.shape[-1]
    A = features.reshape(-1, d)
    n_rows = A.shape[0]
    if n_rows < d:
        At = torch.as_tensor(A, device=device)
        gram = At @ At.T
        if bias:
            gram = gram + 1.0
        return float(torch.linalg.eigvalsh(gram / (4 * n_rows))[-1])
    if bias:
        A = np.concatenate([A, np.ones((n_rows, 1), A.dtype)], axis=1)
    return float(np.linalg.eigvalsh(A.T @ A / (4 * n_rows))[-1])


def logreg_problem(n_clients=30, m=100, d=20, alpha=50.0, beta=50.0, seed=0,
                   lam=0.003, x64=True, device=None):
    """The paper's sparse-logistic-regression setup, with features normalized
    to unit max row norm.  Returns ``(data, reg, grad_fn, full_grad_fn,
    params0, L)`` like the reference; ``data`` holds numpy arrays, while
    ``full_grad_fn`` and ``params0`` live on ``device`` (``cuda`` unless
    given)."""
    dev = resolve_device(device)
    data = logistic_heterogeneous(n_clients=n_clients, m_per_client=m, d=d,
                                  alpha=alpha, beta=beta, seed=seed)
    scale = np.linalg.norm(data.features.reshape(-1, d), axis=1).max()
    dt = np.float64 if x64 else np.float32
    data.features = (data.features / scale).astype(dt)
    data.labels = data.labels.astype(dt)
    L = smoothness(data.features, dev)
    reg = L1(lam=lam)
    grad_fn = logreg.make_grad_fn()
    full_g = logreg.full_gradient_fn(data.features, data.labels, device=dev)
    tdt = torch.float64 if x64 else torch.float32
    params0 = {"w": torch.zeros(d, dtype=tdt, device=dev),
               "b": torch.zeros((), dtype=tdt, device=dev)}
    return data, reg, grad_fn, full_g, params0, L
