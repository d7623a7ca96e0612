"""Counters and histograms behind one snapshot schema.

A numpy-only copy of the part of the reference's :mod:`repro.obs.metrics`
registry that the serving engine uses, so the port never imports
``repro``; the reference's gauges, ``Histogram.merge_counts`` and JSONL
sink are not ported yet.  Two instrument kinds:

  * :class:`Counter` -- monotone accumulator (``add``); floats allowed;
  * :class:`Histogram` -- either *integer buckets* (value v lands in bucket
    ``min(int(v), n-1)``, last bucket = overflow, the staleness ledger's
    idiom) or explicit float *edges* (``np.searchsorted``).

Thread safety is per instrument.  Snapshot schema (one dict, stable
keys)::

    {"counters":   {name: float},
     "histograms": {name: {"counts": [int...], "n": int, "sum": float,
                           "buckets": int | None, "edges": [...] | None}}}
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Union

import numpy as np

__all__ = ["Counter", "Histogram", "MetricsRegistry", "AGE_BUCKETS"]

#: default integer-bucket count, the staleness ledger's AGE_HIST_BUCKETS
AGE_BUCKETS = 8


class Counter:
    """Monotone float accumulator."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def add(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative add {v}")
        with self._lock:
            self._v += v

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Integer-bucket (the AGE_HIST_BUCKETS idiom) or explicit-edge
    histogram.

    ``buckets=n``: value v lands in ``min(max(int(v), 0), n-1)``; the last
    bucket is the overflow bin.  ``edges=[e0, e1, ...]``: n+1 bins via
    ``searchsorted`` (values below e0 land in bin 0, above e_last in the
    final bin).
    """

    __slots__ = ("name", "buckets", "edges", "counts", "n", "sum", "_lock")

    def __init__(self, name: str, buckets: Optional[int] = None,
                 edges: Optional[Sequence[float]] = None):
        if (buckets is None) == (edges is None):
            raise ValueError(
                f"histogram {name}: exactly one of buckets/edges")
        self.name = name
        self.buckets = int(buckets) if buckets is not None else None
        self.edges = (np.asarray(edges, np.float64)
                      if edges is not None else None)
        if self.buckets is not None and self.buckets < 1:
            raise ValueError(f"histogram {name}: buckets must be >= 1")
        if self.edges is not None and (
                len(self.edges) < 1 or np.any(np.diff(self.edges) <= 0)):
            raise ValueError(f"histogram {name}: edges must be increasing")
        nbins = self.buckets if self.buckets is not None \
            else len(self.edges) + 1
        self.counts = np.zeros(nbins, np.int64)
        self.n = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def _bucket_of(self, v: Union[float, np.ndarray]) -> np.ndarray:
        v = np.asarray(v, np.float64)
        if self.buckets is not None:
            return np.clip(v.astype(np.int64), 0, self.buckets - 1)
        return np.searchsorted(self.edges, v, side="right")

    def observe(self, v, n: int = 1) -> None:
        """Record scalar ``v`` (``n`` times) or an array of values."""
        arr = np.atleast_1d(np.asarray(v, np.float64))
        ix = self._bucket_of(arr)
        with self._lock:
            np.add.at(self.counts, ix, int(n))
            self.n += arr.size * int(n)
            self.sum += float(arr.sum()) * int(n)

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def quantile(self, q: float) -> float:
        """Conservative q-quantile from the bucket counts: the UPPER bound
        of the bin holding the q-th observation (so a reported p99 latency
        is never optimistic).  Overflow bins return their lower edge --
        the histogram cannot bound them from above.  0.0 with no data."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"histogram {self.name}: quantile {q} not in [0,1]")
        with self._lock:
            counts = self.counts.copy()
            n = self.n
        if n == 0:
            return 0.0
        rank = q * n
        cum = np.cumsum(counts)
        i = int(np.searchsorted(cum, rank, side="left"))
        i = min(i, len(counts) - 1)
        if self.buckets is not None:
            # integer buckets: bin i covers [i, i+1); last bin is overflow
            return float(i + 1 if i < self.buckets - 1 else i)
        # edge bins: bin 0 = (-inf, e0], bin i = (e_{i-1}, e_i],
        # final bin = (e_last, inf) -> bounded only from below
        return float(self.edges[min(i, len(self.edges) - 1)])

    def snapshot(self) -> dict:
        return {"counts": [int(x) for x in self.counts],
                "n": int(self.n), "sum": float(self.sum),
                "buckets": self.buckets,
                "edges": (None if self.edges is None
                          else [float(e) for e in self.edges])}


class MetricsRegistry:
    """Get-or-create factory for named instruments + one snapshot schema."""

    def __init__(self):
        self._by_name: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind, *args, **kw):
        with self._lock:
            inst = self._by_name.get(name)
            if inst is None:
                inst = kind(name, *args, **kw)
                self._by_name[name] = inst
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {kind.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def histogram(self, name: str, buckets: Optional[int] = None,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        if buckets is None and edges is None:
            buckets = AGE_BUCKETS
        return self._get(name, Histogram, buckets, edges)

    def snapshot(self) -> dict:
        """All instruments, one JSON-serializable dict (see module
        docstring for the schema)."""
        with self._lock:
            items = list(self._by_name.items())
        out = {"counters": {}, "histograms": {}}
        for name, inst in items:
            if isinstance(inst, Counter):
                out["counters"][name] = float(inst.value)
            else:
                out["histograms"][name] = inst.snapshot()
        return out
