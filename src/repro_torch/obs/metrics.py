"""Unified metrics: counters / gauges / histograms behind ONE schema.

The numpy-only counterpart of :mod:`repro.obs.metrics` (a copy, so the port
never imports ``repro``): the uplink sender's ``send_wait_s`` /
``sender_busy_s``, the runtime server's commit path and the serving
engine's counters land in one registry with a single JSON-serializable
snapshot shape and a JSONL sink whose lines are the reference's for the
same events.

Three instrument kinds, deliberately small:

  * :class:`Counter` -- monotone accumulator (``add``); floats allowed, so
    second-counters like ``uplink/send_wait_s`` are counters too;
  * :class:`Gauge` -- last-write-wins (``set``);
  * :class:`Histogram` -- either *integer buckets* (value v lands in bucket
    ``min(int(v), n-1)``, last bucket = overflow -- the staleness ledger's
    ``AGE_HIST_BUCKETS`` idiom, so ``ArrivalLedger.age_histogram`` merges
    in unchanged), or explicit float *edges* (``np.searchsorted``).

Thread safety is per instrument (the server's commit path updates from
several connection threads).

Snapshot schema (one dict, stable keys -- what the JSONL sink writes)::

    {"counters":   {name: float},
     "gauges":     {name: float},
     "histograms": {name: {"counts": [int...], "n": int, "sum": float,
                           "buckets": int | None, "edges": [...] | None}}}
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "JsonlSink",
           "AGE_BUCKETS"]

SCHEMA = "repro.obs.metrics/v1"

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


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

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

    def merge_counts(self, counts) -> None:
        """Fold an externally built bucket array (e.g.
        ``ArrivalLedger.age_histogram()``) into this histogram.  Bucket
        geometry must match; ``sum`` is approximated by bucket index."""
        c = np.asarray(counts, np.int64)
        if c.shape != self.counts.shape:
            raise ValueError(
                f"histogram {self.name}: cannot merge {c.shape} into "
                f"{self.counts.shape}")
        with self._lock:
            self.counts += c
            self.n += int(c.sum())
            self.sum += float((c * np.arange(len(c))).sum())

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

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

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
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in items:
            if isinstance(inst, Counter):
                out["counters"][name] = float(inst.value)
            elif isinstance(inst, Gauge):
                out["gauges"][name] = float(inst.value)
            else:
                out["histograms"][name] = inst.snapshot()
        return out


class JsonlSink:
    """Append-only JSONL: one self-describing line per record.

    Every line carries the schema tag and a monotonic timestamp
    (``time.perf_counter`` -- the tracer clock), so merged logs from one
    process sort correctly even when wall clocks step.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def write(self, event: str, **fields) -> None:
        rec = {"schema": SCHEMA, "event": event,
               "t_mono": time.perf_counter(), "t_unix": time.time()}
        rec.update(fields)
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            self._f.write(line + "\n")

    def write_snapshot(self, registry: MetricsRegistry, **fields) -> None:
        self.write("snapshot", metrics=registry.snapshot(), **fields)

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
            finally:
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
