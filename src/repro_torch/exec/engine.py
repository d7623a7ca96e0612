"""The bare round-execution engine (no stages).

The counterpart of :class:`repro.exec.RoundEngine` without its stages
(placement, compression, asynchrony, cohorts): it runs one
(algorithm, grad_fn, n_clients) triple round after round.

  * A *chunk* of ``chunk_rounds`` rounds is a Python loop; the per-round
    metrics stay on the device and are fetched with ONE host sync per chunk.
    Chunking changes nothing in the trajectory: ``chunk_rounds=1`` and
    ``chunk_rounds=8`` give bitwise-equal states.
  * Batches come from a chunk-aware supplier (:mod:`repro_torch.exec.suppliers`)
    or a plain ``supplier(round_idx, rng)`` callable, and are moved to the
    engine's device.
  * Partial participation (``EngineConfig.participation``) samples one
    active-client mask per round.  The numpy rng is consumed in the
    reference's order -- per round, the batch draw, then the mask draw -- so
    batches and masks equal the reference's.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device
from repro_torch.exec.suppliers import as_supplier, has_chunk_path
from repro_torch.utils import tree as tu


@dataclass(frozen=True)
class EngineConfig:
    """Execution options -- orthogonal to the algorithm being run.

    chunk_rounds   : rounds run between two host syncs of the metrics.
    participation  : if set, the fraction of clients active each round
                     (uniform sampling without replacement, >= 1 client).
                     Requires a round function with an ``active`` argument.
    """

    chunk_rounds: int = 1
    participation: Optional[float] = None

    def validate(self) -> None:
        if self.chunk_rounds < 1:
            raise ValueError(
                f"chunk_rounds must be >= 1, got {self.chunk_rounds}")
        if self.participation is not None and not (
                0.0 < self.participation <= 1.0):
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")


def rounds_to_boundary(r: int, every: int, total: int) -> int:
    """Rounds from ``r`` to the next multiple of ``every``, capped at
    ``total`` -- the segment length drivers hand to :meth:`RoundEngine.run`
    between periodic eval points."""
    return min(total, (r // every + 1) * every) - r


def sample_active_masks(n_clients: int, n_rounds: int, participation: float,
                        rng: np.random.Generator) -> np.ndarray:
    """(n_rounds, n_clients) bool masks: uniform subsampling w/o replacement."""
    m = max(1, int(round(participation * n_clients)))
    masks = np.zeros((n_rounds, n_clients), bool)
    for r in range(n_rounds):
        masks[r, rng.choice(n_clients, size=m, replace=False)] = True
    return masks


class RoundEngine:
    """Runs federated rounds for one (algorithm, grad_fn, n_clients) triple
    on one device (``cuda`` unless ``device`` says otherwise)."""

    def __init__(self, algorithm, grad_fn, n_clients: int,
                 config: EngineConfig = EngineConfig(), *, device=None):
        config.validate()
        self.algorithm = algorithm
        self.grad_fn = grad_fn
        self.n_clients = n_clients
        self.config = config
        self.device = resolve_device(device)
        self._round_fn = algorithm.make_round_fn(grad_fn)
        self._accepts_active = (
            "active" in inspect.signature(self._round_fn).parameters)
        if config.participation is not None and not self._accepts_active:
            raise ValueError(
                f"algorithm {algorithm.name!r} does not support partial "
                "participation (round_fn has no 'active' argument)")
        self._use_active = config.participation is not None

    def init(self, params0):
        """Algorithm state on the engine's device."""
        return self.algorithm.init(to_device(params0, self.device),
                                   self.n_clients)

    def _round(self, state, batches, active):
        batches = to_device(batches, self.device)
        if active is None:
            return self._round_fn(state, batches)
        return self._round_fn(
            state, batches,
            active=torch.as_tensor(active, device=self.device))

    def run(self, state, batch_supplier, rounds: int, *,
            rng: Optional[np.random.Generator] = None, seed: int = 0,
            start_round: int = 0):
        """Run ``rounds`` rounds from ``state``; returns (state, metrics).

        ``metrics`` maps metric name -> list with one float per executed
        round.  Chunk-aware suppliers serve whole chunks through
        ``sample_chunk``; under partial participation, or for a plain
        callable, batches are drawn per round, each followed by that round's
        mask draw.
        """
        if rng is None:
            rng = np.random.default_rng(seed)
        supplier = as_supplier(batch_supplier)
        use_chunk = has_chunk_path(supplier) and not self._use_active
        metrics: dict[str, list] = {}
        done = 0
        while done < rounds:
            c = min(self.config.chunk_rounds, rounds - done)
            r0 = start_round + done
            infos = []
            if use_chunk:
                chunk = supplier.sample_chunk(r0, c, rng)
                for i in range(c):
                    state, info = self._round(
                        state, tu.tree_map(lambda x: x[i], chunk), None)
                    infos.append(info)
            else:
                for i in range(c):
                    batches = supplier.sample_round(r0 + i, rng)
                    active = (sample_active_masks(
                        self.n_clients, 1, self.config.participation, rng)[0]
                        if self._use_active else None)
                    state, info = self._round(state, batches, active)
                    infos.append(info)
            # the chunk's ONE host sync: every round's metrics in one copy
            keys = list(infos[0])
            if keys:
                vals = torch.stack([torch.stack([info[k].float() for k in keys])
                                    for info in infos]).cpu().numpy()
                for j, k in enumerate(keys):
                    metrics.setdefault(k, []).extend(
                        float(v) for v in vals[:, j])
            done += c
        return state, metrics

    def step(self, state, batches, active=None):
        """One round (the ``round_fn(state, batches)`` surface)."""
        if active is not None and not self._accepts_active:
            raise ValueError("this algorithm's round_fn takes no active mask")
        if self._use_active and active is None:
            raise ValueError("engine configured with participation; pass the "
                             "active mask explicitly to step()")
        state, info = self._round(state, batches, active)
        return state, {k: float(v) for k, v in info.items()}

    def global_params(self, state):
        return self.algorithm.global_params(state)
