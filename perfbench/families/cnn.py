"""The paper's MNIST CNN (``"family": "cnn"``), trained on per-client
image sets of unequal sizes through a plain callable supplier, as the
program's Fig. 4 runs are fed."""
from __future__ import annotations

import math

import numpy as np
import torch

from pb import costs
from pb.spec import checked_rounds
from reference import cnn as ref_model


def _leaves(cfg):
    """(name, shape, fan_in) in the program's ``init_params`` order;
    fan_in None marks a bias (zeros).  Weights are He-normal."""
    k, (hw, _, c), pool = cfg["kernel"], cfg["image"], cfg["pool"]
    out = []
    for j, c_out in enumerate(cfg["conv_channels"], start=1):
        out += [(f"conv{j}_w", (k, k, c, c_out), k * k * c),
                (f"conv{j}_b", (c_out,), None)]
        hw, c = hw // pool, c_out
    width = hw * hw * c
    for j, units in enumerate(cfg["dense"], start=1):
        out += [(f"fc{j}_w", (width, units), width),
                (f"fc{j}_b", (units,), None)]
        width = units
    return out


def n_params(cfg) -> int:
    return sum(math.prod(s) for _, s, _ in _leaves(cfg))


def init_params(cfg, seed: int, device) -> dict:
    """Float32 weights drawn on ``device`` by one generator seeded with
    ``seed``, in one call; zero biases."""
    leaves = _leaves(cfg)
    total = sum(math.prod(s) for _, s, f in leaves if f is not None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape, fan_in in leaves:
        if fan_in is None:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape).mul_(
                math.sqrt(2.0 / fan_in))
            off += k
    return out


def port_grad_fn(cfg):
    """The program's CNN, which is this configuration's architecture (in
    float32 with TF32 off, as the reference computes it)."""
    from repro_torch.models import cnn

    ref_model.require_architecture(cfg)

    shapes = {name: tuple(shape) for name, shape, _ in _leaves(cfg)}
    ported = {name: tuple(v.shape) for name, v in
              cnn.init_params(0, device="meta").items()}
    if shapes != ported:
        raise ValueError(f"the program's CNN has shapes {ported}, the "
                         f"configuration {shapes}")
    return cnn.make_grad_fn()


class Feed:
    """Each round, per client, ``tau x batch`` indices drawn with
    replacement from the run's generator; the images are gathered on the
    host, as Fig. 4's supplier does.  The batches of the rounds the
    reference follows are kept for it."""

    def __init__(self, traffic, clients, seed: int, device):
        self.clients, self.device = clients, device
        self.keep = checked_rounds(traffic)
        self.tau, self.b = traffic["tau"], traffic["batch"]
        self.kept: dict = {}
        self.supplier = self

    def __call__(self, r, rng):
        n = len(self.clients)
        xs = np.empty((n, self.tau, self.b, 28, 28, 1), np.float32)
        ys = np.empty((n, self.tau, self.b), np.int32)
        for i, (x, y) in enumerate(self.clients):
            idx = rng.integers(0, len(y), size=(self.tau, self.b))
            xs[i], ys[i] = x[idx], y[idx]
        if r < self.keep:
            self.kept[r] = {"x": xs.copy(), "y": ys.copy()}
        return {"x": xs, "y": ys}

    def reference_batches(self, rounds: int) -> list:
        return [{k: torch.as_tensor(v, device=self.device)
                 for k, v in self.kept[r].items()} for r in range(rounds)]


def reference_loss_and_grad(cfg, precision: str):
    return ref_model.loss_and_grad(cfg, precision)


def costs_of(cfg, traffic) -> dict:
    examples = traffic["clients"] * traffic["tau"] * traffic["batch"]
    per = costs.cnn_train_flops_per_example(
        cfg["image"], cfg["conv_channels"], cfg["kernel"], cfg["pool"],
        cfg["dense"])
    return {"model_flops_per_round": per * examples,
            "k1_bound_s_per_round": traffic["tau"] * costs.fused_prox_bytes(
                n_params(cfg), traffic["clients"], 4)
            / costs.HBM_BYTES_PER_S}
