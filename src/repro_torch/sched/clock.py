"""Virtual-time client clock models for the simulated-asynchrony stage.

The counterpart of :mod:`repro.sched.clock`.  A :class:`ClockModel` maps
``(draws, round_idx, n_clients, device)`` to the virtual duration each
client needs for the local round it starts now: a client that syncs at
virtual time ``T`` delivers its report at ``T + duration``, and the server
commits once ``buffer_size`` reports have arrived.  Durations decide *which*
reports are stale and by how much, never the round math itself.

The reference draws from a ``jax.random`` key; the port draws from a draw
source (:class:`repro_torch.comm.GeneratorDraws` or
:class:`repro_torch.comm.ReplayDraws`), with ``normal`` and ``bernoulli``
consumed in a fixed order: per round the compute stream's draws, then the
upload stream's.  Deterministic clocks draw nothing.  Durations are float32,
as the reference keeps them.

  * :class:`DeterministicClock` -- every client takes the same fixed time
    (or an explicit per-client vector); ``DeterministicClock()`` is the
    zero-delay clock.
  * :class:`LogNormalClock` -- i.i.d. ``median * exp(sigma * N(0, 1))``.
  * :class:`StragglerClock` -- a fraction of clients ``slowdown`` times
    slower (persistently, or re-drawn per round), times log-normal jitter.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch


class ClockModel:
    """Interface: per-client virtual round durations from a draw source.

    ``stochastic = False`` marks clocks that draw nothing.  ``upload`` splits
    a round into a compute and an upload stream (``None`` | a constant
    upload time | another :class:`ClockModel`); under the multi-slot report
    queue only uploads serialize behind a client's in-flight reports.
    ``upload=None`` gives the single-stream durations, with zero upload.
    """

    name: str = "base"
    stochastic: bool = True
    upload: Any = None

    def durations(self, draws, round_idx, n_clients: int,
                  device) -> torch.Tensor:
        """``(n_clients,)`` float32 vector of strictly positive durations."""
        raise NotImplementedError

    def split_durations(self, draws, round_idx, n_clients: int,
                        device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(compute, upload)`` per-client duration vectors; the compute
        stream draws first."""
        comp = self.durations(draws, round_idx, n_clients, device)
        up = self.upload
        if up is None:
            return comp, torch.zeros((n_clients,), dtype=torch.float32,
                                     device=device)
        if isinstance(up, ClockModel):
            return comp, up.durations(draws, round_idx, n_clients, device)
        return comp, torch.full((n_clients,), float(up), dtype=torch.float32,
                                device=device)


def _upload_stochastic(upload) -> bool:
    return isinstance(upload, ClockModel) and upload.stochastic


def clock_is_stochastic(clock) -> bool:
    """Whether either duration stream draws (duck-typed clocks that only
    implement ``durations`` count as stochastic, with no upload)."""
    return (getattr(clock, "stochastic", True)
            or _upload_stochastic(getattr(clock, "upload", None)))


def split_durations(clock, draws, round_idx, n_clients: int, device):
    """``(compute, upload)`` streams of any clock, duck-typed clocks with
    only ``durations`` included (zero upload)."""
    fn = getattr(clock, "split_durations", None)
    if fn is not None:
        return fn(draws, round_idx, n_clients, device)
    return (clock.durations(draws, round_idx, n_clients, device),
            torch.zeros((n_clients,), dtype=torch.float32, device=device))


@dataclass(frozen=True)
class DeterministicClock(ClockModel):
    """Fixed durations: one scalar for all clients, or a per-client vector.

    With the default ``duration=1.0`` every client finishes at the same
    virtual instant -- the zero-delay clock: with ``buffer_size=n_clients``
    the async engine is bitwise the synchronous one.
    """

    duration: float = 1.0
    per_client: Optional[Tuple[float, ...]] = None
    upload: Any = None
    name: str = "deterministic"
    stochastic: bool = False

    def durations(self, draws, round_idx, n_clients, device):
        if self.per_client is not None:
            d = torch.tensor(self.per_client, dtype=torch.float32,
                             device=device)
            if tuple(d.shape) != (n_clients,):
                raise ValueError(
                    f"per_client durations have shape {tuple(d.shape)}, "
                    f"expected ({n_clients},)")
            return d
        return torch.full((n_clients,), self.duration, dtype=torch.float32,
                          device=device)


@dataclass(frozen=True)
class LogNormalClock(ClockModel):
    """I.i.d. log-normal durations: ``median * exp(sigma * N(0,1))`` per
    client per round.  ``sigma=0`` degenerates to the deterministic clock."""

    median: float = 1.0
    sigma: float = 0.5
    upload: Any = None
    name: str = "lognormal"

    def durations(self, draws, round_idx, n_clients, device):
        z = draws.normal((n_clients,), torch.float32, device)
        return self.median * torch.exp(self.sigma * z)


@dataclass(frozen=True)
class StragglerClock(ClockModel):
    """Straggler mixture on top of log-normal jitter.

    ``persistent=True``: the first ``ceil(straggler_frac * n_clients)``
    clients are always ``slowdown`` times slower.  ``persistent=False``:
    straggling is re-drawn per (client, round) with probability
    ``straggler_frac`` (one ``bernoulli`` draw after the jitter's
    ``normal``).
    """

    base: float = 1.0
    straggler_frac: float = 0.25
    slowdown: float = 4.0
    jitter: float = 0.1
    persistent: bool = True
    upload: Any = None
    name: str = "straggler"

    def durations(self, draws, round_idx, n_clients, device):
        z = draws.normal((n_clients,), torch.float32, device)
        mult = torch.exp(self.jitter * z)
        if self.persistent:
            n_slow = int(math.ceil(self.straggler_frac * n_clients))
            slow = torch.arange(n_clients, device=device) < n_slow
        else:
            slow = draws.bernoulli(self.straggler_frac, (n_clients,), device)
        factor = torch.where(
            slow, torch.tensor(self.slowdown, dtype=torch.float32,
                               device=device),
            torch.tensor(1.0, dtype=torch.float32, device=device))
        return self.base * factor * mult


_CLOCKS = {"deterministic": DeterministicClock, "lognormal": LogNormalClock,
           "straggler": StragglerClock}


def get_clock(name: str, **kwargs) -> ClockModel:
    """Build a clock by name ('deterministic', 'lognormal', 'straggler')."""
    try:
        cls = _CLOCKS[name]
    except KeyError:
        raise ValueError(
            f"unknown clock {name!r}; available: {sorted(_CLOCKS)}")
    return cls(**kwargs)
