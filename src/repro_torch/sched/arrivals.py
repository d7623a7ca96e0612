"""Real-time arrival ledger for a multi-process runtime.

The counterpart of :mod:`repro.sched.arrivals`, copied so that the port
never imports the reference.

The simulated asynchrony stage (:mod:`repro_torch.sched.aggregator`) ages reports
in *virtual* time drawn from a :class:`ClockModel`.  Once workers are real
processes (the reference's :mod:`repro.fed.runtime`), arrival times stop being a model: the
server observes actual wall-clock instants on its socket.  This ledger is
the real-time counterpart of the virtual ``last_synced`` bookkeeping -- it
records every chunk arrival (who, which rounds, how many wire bytes, against
which committed version) and derives the same quantities the virtual ledger
feeds to metrics: per-worker report age, inter-arrival statistics, byte
rates, and the age histogram over :data:`repro_torch.sched.AGE_HIST_BUCKETS`.

Ages here are measured in *commit versions* (how many server commits
happened since the worker last synced), the FedBuff notion of staleness
that :class:`repro_torch.sched.Staleness` weights by -- so the runtime can reuse
``Staleness.weights`` unchanged on real arrivals.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["Arrival", "ArrivalLedger"]


@dataclass(frozen=True)
class Arrival:
    """One uplink chunk landing on the server."""

    worker: int
    start_round: int
    rounds: int
    nbytes: int
    base_version: int  # server commit version the worker computed against
    version: int       # commit version at arrival (age = version - base)
    t: float           # seconds since ledger start (monotonic clock)

    @property
    def age(self) -> int:
        return self.version - self.base_version


@dataclass
class ArrivalLedger:
    """Append-only record of real uplink arrivals + derived staleness stats.

    The server's receive loop calls :meth:`record` once per decoded CHUNK
    frame and :meth:`bump` once per commit; everything else is read-only
    derivation.  ``weights_for`` maps a batch of arrivals through a
    :class:`repro_torch.sched.Staleness` policy exactly as the virtual-time
    aggregator would, so real and simulated runs share one weighting rule.
    """

    arrivals: list = field(default_factory=list)
    version: int = 0
    _t0: Optional[float] = None

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = time.monotonic()
        return time.monotonic() - self._t0

    def record(self, worker: int, start_round: int, rounds: int,
               nbytes: int, base_version: int,
               t: Optional[float] = None) -> Arrival:
        a = Arrival(worker=int(worker), start_round=int(start_round),
                    rounds=int(rounds), nbytes=int(nbytes),
                    base_version=int(base_version), version=self.version,
                    t=self._now() if t is None else float(t))
        self.arrivals.append(a)
        return a

    def bump(self, n: int = 1) -> int:
        """Advance the commit version (one server commit applied)."""
        self.version += n
        return self.version

    # -- derived views ----------------------------------------------------

    def ages(self) -> np.ndarray:
        return np.asarray([a.age for a in self.arrivals], np.int64)

    def age_histogram(self, buckets: Optional[int] = None) -> np.ndarray:
        """Report-age counts per integer age, last bucket = overflow --
        the same shape as the virtual ledger's ``AGE_HIST_BUCKETS``
        histogram in the engine's async metrics."""
        if buckets is None:
            from repro_torch.sched import AGE_HIST_BUCKETS

            buckets = AGE_HIST_BUCKETS
        ages = np.clip(self.ages(), 0, buckets - 1)
        return np.bincount(ages, minlength=buckets).astype(np.int64)

    def weights_for(self, arrivals, staleness) -> np.ndarray:
        """Staleness weights of ``arrivals`` under a
        :class:`repro_torch.sched.Staleness` policy -- the real-time analogue of
        the virtual aggregator's per-report weighting."""
        import torch

        ages = torch.as_tensor([a.age for a in arrivals], dtype=torch.float64)
        return staleness.weights(ages).numpy()

    def summary(self) -> dict:
        """Aggregate wall-clock + byte statistics for metrics/logging."""
        if not self.arrivals:
            return {"arrivals": 0, "bytes": 0, "version": self.version}
        ts = np.asarray([a.t for a in self.arrivals])
        by_worker: dict[int, list] = {}
        for a in self.arrivals:
            by_worker.setdefault(a.worker, []).append(a)
        inter = np.diff(np.sort(ts)) if len(ts) > 1 else np.asarray([0.0])
        total_b = int(sum(a.nbytes for a in self.arrivals))
        span = float(ts.max() - ts.min()) if len(ts) > 1 else 0.0
        ages = self.ages()
        return {
            "arrivals": len(self.arrivals),
            "workers": len(by_worker),
            "version": self.version,
            "bytes": total_b,
            "bytes_per_s": total_b / span if span > 0 else float("inf"),
            "mean_interarrival_s": float(inter.mean()),
            "mean_age": float(ages.mean()),
            "max_age": int(ages.max()),
            "last_arrival_s": float(ts.max()),
        }
