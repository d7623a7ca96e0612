"""The program under test, built from its public constructors as its own
trainers build it: an algorithm (``DProxAlgorithm`` or ``FedDA``) with an
L1 regularizer, the family's gradient function, a ``RoundEngine`` with
the traffic's chunk and uplink, and the family's supplier.  Every round
the benchmark runs goes through ``RoundEngine.run``."""
from __future__ import annotations

import gc

import numpy as np
import torch


def flat(tree, prefix: str = "") -> dict:
    """A nested dict of tensors as path -> tensor."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, path + "."))
        else:
            out[path] = v
    return out


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def _soft(x, t: float):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def _reset_peak() -> None:
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def _peak() -> int:
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0


class Program:
    def __init__(self, cell, family, params, data, seed: int, device):
        from repro_torch.comm import get_transport
        from repro_torch.core.algorithm import DProxConfig
        from repro_torch.core.baselines import FedDA
        from repro_torch.core.prox import L1
        from repro_torch.exec import EngineConfig, RoundEngine
        from repro_torch.fed.simulator import DProxAlgorithm

        t = cell.traffic
        self.traffic = t
        reg = L1(lam=t["lam"])
        if t["algorithm"] == "dprox":
            alg = DProxAlgorithm(reg, DProxConfig(tau=t["tau"], eta=t["eta"],
                                                  eta_g=t["eta_g"]))
        elif t["algorithm"] == "fedda":
            alg = FedDA(reg, t["tau"], t["eta"], t["eta_g"])
        else:
            raise ValueError(f"unknown algorithm {t['algorithm']!r}")
        tr = t.get("transport")
        transport = (None if tr is None else get_transport(
            tr["name"], ratio=tr["ratio"], granularity=tr["granularity"]))
        self.engine = RoundEngine(
            alg, family.port_grad_fn(cell.config), t["clients"],
            EngineConfig(chunk_rounds=t["chunk"], transport=transport,
                         plane=bool(tr and tr.get("plane"))),
            device=device)
        self.feed = family.Feed(t, data, seed, device)
        self.costs = family.costs_of(cell.config, t)
        self.state = self.engine.init(params)
        self.rng = np.random.default_rng(seed)
        self.round = 0

    def rounds(self, k: int) -> list:
        """Run ``k`` rounds (chunks of the traffic's ``chunk``); their
        train losses."""
        self.state, m = self.engine.run(self.state, self.feed.supplier, k,
                                        rng=self.rng, start_round=self.round)
        self.round += k
        return [float(x) for x in m["train_loss"]]

    def check_rounds(self, regen) -> dict:
        """The rounds the reference follows, read as it reads its own: round
        1 alone, then one chunk of the traffic's ``chunk`` rounds through
        the window's own call (the first call of the window's shape, so it
        is the warm chunk too).  Each round's train loss; after round 1 the
        gradient as the server state keeps it, worked out from that state
        (DProx: each client's mean gradient, c_i = (p0 - x_bar1) /
        (eta_g eta tau) - g_i; FedDA: their mean, (p0 - x_bar1) /
        (eta_g eta tau)); after the chunk the change of x_bar.  ``regen()``
        makes the initial weights again (until round 1 they are the state's
        own x_bar).

        Also ``peak``: the device's peak memory over the chunk alone.  Its
        count starts after round 1's readings are freed, so neither they
        nor round 1 (run alone, with the initial weights kept for the
        readings) enter it."""
        t = self.traffic
        scale = 1.0 / (t["eta_g"] * t["eta"] * t["tau"])
        thresh = t["eta"] * t["eta_g"] * t["tau"] * t["lam"]
        params0 = flat(self.state.x_bar)
        loss = self.rounds(1)
        x1 = flat(self.state.x_bar)
        c = getattr(self.state, "c", None)
        c = flat(c) if c is not None else None
        grad1 = {}
        for k in list(params0):
            a = scale * (_soft(params0.pop(k), thresh) - x1[k])
            if c is None:
                grad1[k] = _norm(a)
            else:  # one client at a time: no (clients, ...) temporary
                grad1[k] = sum(_norm(a - ci) ** 2 for ci in c[k]) ** 0.5
            del a
        del x1, c, params0
        _reset_peak()
        loss += self.rounds(t["chunk"])
        peak = _peak()
        x0 = flat(regen())
        x = flat(self.state.x_bar)
        dx = {k: _norm(x[k] - x0[k]) for k in x0}
        del x0, x
        _reset_peak()
        return {"loss": loss, "grad1": grad1, "dx": dx, "peak": peak}

    def close(self) -> None:
        """Free the program's state (the engine holds reference cycles)."""
        self.state = self.engine = self.feed = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
