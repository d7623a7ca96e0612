"""Low-overhead span tracing (the part of :mod:`repro.obs.trace` the serving
engine and the snapshot store use).

A copy of the reference's numpy-only tracer, so the port never imports
``repro``: the default tracer is :data:`NULL_TRACER`, whose ``span()``
returns one shared no-op context manager (no clock read, no allocation);
:func:`install` enables a :class:`Tracer` that records spans into a
preallocated numpy ring buffer on the monotonic clock :func:`now`.  The
wire export, the Chrome/Perfetto merge and ``uninstall`` are not ported
yet: until then an installed tracer's spans have no reader beyond its
``n_spans`` and ``dropped`` counts.
"""
from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np

__all__ = ["now", "Tracer", "NullTracer", "NULL_TRACER", "install", "span",
           "instant"]

#: THE tracer clock: monotonic, high-resolution, per-process epoch.
now = time.perf_counter


# ---------------------------------------------------------------------------
# null path (the default): no clock reads, no allocation
# ---------------------------------------------------------------------------


class _NullSpan:
    """Shared, stateless no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a no-op."""

    enabled = False
    process = "off"

    def span(self, name: str, cat: str = "", **args):
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "", **args) -> None:
        pass


NULL_TRACER = NullTracer()


# ---------------------------------------------------------------------------
# the real tracer
# ---------------------------------------------------------------------------


class _Span:
    """One in-flight span; records (t0, t1) into the tracer on exit."""

    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0")

    def __init__(self, tr, name, cat, args):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = now()
        return self

    def __exit__(self, *exc):
        self._tr._record(self._name, self._cat, self._t0, now(), self._args)
        return False

    def set(self, **kw) -> None:
        """Attach args discovered mid-span (e.g. byte counts known only
        after serialization); recorded at span exit."""
        if self._args is None:
            self._args = kw
        else:
            self._args.update(kw)


class Tracer:
    """Preallocated-ring span recorder for one process.

    ``capacity`` bounds memory: a span is 28 bytes of ring columns plus one
    list slot for its (usually ``None``) args dict.  When full, the oldest
    spans are overwritten and ``dropped`` counts them.
    """

    enabled = True

    def __init__(self, process: str, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.process = process
        self.capacity = capacity
        self._t0 = np.zeros(capacity, np.float64)
        self._t1 = np.zeros(capacity, np.float64)
        self._name_ix = np.zeros(capacity, np.int32)
        self._cat_ix = np.zeros(capacity, np.int32)
        self._tid_ix = np.zeros(capacity, np.int32)
        self._args: list = [None] * capacity
        self._n = 0  # total spans ever recorded (ring head = _n % capacity)
        self._names: list = []
        self._name_of: dict = {}
        self._tids: list = []     # thread labels, index = tid_ix
        self._tid_of: dict = {}   # thread ident -> tid_ix
        self._lock = threading.Lock()

    # -- recording --------------------------------------------------------

    def span(self, name: str, cat: str = "", **args):
        """Context manager timing one span; ``**args`` are recorded with
        it."""
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """A zero-duration marker."""
        t = now()
        self._record(name, cat, t, t, args or None)

    def _intern(self, s: str) -> int:
        ix = self._name_of.get(s)
        if ix is None:
            ix = len(self._names)
            self._names.append(s)
            self._name_of[s] = ix
        return ix

    def _record(self, name, cat, t0, t1, args) -> None:
        th = threading.current_thread()
        with self._lock:
            tid = self._tid_of.get(th.ident)
            if tid is None:
                tid = len(self._tids)
                self._tids.append(th.name)
                self._tid_of[th.ident] = tid
            i = self._n % self.capacity
            self._t0[i] = t0
            self._t1[i] = t1
            self._name_ix[i] = self._intern(name)
            self._cat_ix[i] = self._intern(cat)
            self._tid_ix[i] = tid
            self._args[i] = args
            self._n += 1

    @property
    def n_spans(self) -> int:
        return min(self._n, self.capacity)

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)


# ---------------------------------------------------------------------------
# module-level current tracer
# ---------------------------------------------------------------------------

_TRACER: Any = NULL_TRACER
_INSTALL_LOCK = threading.Lock()


def install(process: str, capacity: int = 1 << 16) -> Tracer:
    """Enable tracing for this process; returns the installed tracer.

    Idempotent: if a tracer is already installed, the existing one is
    returned and keeps its name.
    """
    global _TRACER
    with _INSTALL_LOCK:
        if isinstance(_TRACER, Tracer):
            return _TRACER
        _TRACER = Tracer(process, capacity)
        return _TRACER


def span(name: str, cat: str = "", **args):
    """The current tracer's ``span(...)`` -- the one-liner instrumentation
    sites use."""
    return _TRACER.span(name, cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    _TRACER.instant(name, cat, **args)
