"""Low-overhead span tracing: one cross-process timeline, Perfetto-loadable.

The counterpart of :mod:`repro.obs.trace` (a numpy-only copy, so the port
never imports ``repro``; its wire bundles and Chrome documents are the
reference's, so either package merges the other's).  Every process gets ONE
tracer whose spans assemble into a single Chrome trace-event JSON (open in
Perfetto or chrome://tracing) where worker compute, frame bytes on the wire
and server commits share a common timebase.

Design constraints, in order:

  * **disabled is free** -- the default tracer is :data:`NULL_TRACER`, whose
    ``span()`` returns one shared no-op context manager: no clock read, no
    allocation, no lock, so instrumentation sites stay in hot paths;
  * **low overhead when on** -- spans land in a preallocated numpy ring
    buffer (two float64 clock columns + three int32 index columns); names
    and categories are interned once; the only per-span lock is around the
    ring index.  When the ring wraps, the oldest spans are dropped and
    counted (``dropped``), never reallocated;
  * **monotonic clock** -- :func:`now` is ``time.perf_counter``.
    Cross-process alignment is explicit: each worker estimates its offset
    to the server's clock from the HELLO/ACK handshake
    (:func:`clock_offset`) and the merge applies it;
  * **process/thread tagged** -- every span carries (pid, thread); Chrome
    trace metadata rows name both, so the sender thread, the supplier
    staging thread and the compute thread render as separate tracks;
  * **device intervals on the same clock** -- ``span(..., device=True)``
    also records a pooled CUDA timing event on the current stream at entry
    and at exit (only while a tracer is installed, CUDA is initialised and
    the stream is not capturing).  :meth:`Tracer.settle`, called right
    after a host sync, maps the finished pairs onto :func:`now` through an
    anchor event recorded there (device time = the anchor's host time less
    the event's distance to the anchor; ``anchor_err_us``, the host time
    around the anchor's record and wait, bounds the error) and records
    them, under the same names, on a track of their own: the thread label
    ``cuda:<index>`` in the same process;
  * **per-chunk counters** -- :meth:`Tracer.counters` reads the host syncs
    (counted under ``torch.cuda.set_sync_debug_mode("warn")``, whose
    warnings are counted and never shown; the mode is restored on
    :func:`uninstall`), the caching allocator's ``cudaMalloc`` +
    ``cudaFree`` calls and retries, and the kernels' registry of launches
    and events (``kernels/_build.COUNTS``: ``split_gemms`` ...).

Usage::

    from repro_torch.obs import trace
    tracer = trace.install("worker0")          # enable (idempotent)
    with trace.span("exec/chunk", "exec", start_round=0, rounds=4):
        ...
    doc = trace.to_chrome([tracer.export_wire()])
    trace.write_chrome(doc, "out.json")        # -> load in Perfetto

``tracer.export_wire(device=True)`` adds the device track to the bundle;
without it the bundle holds the host spans alone.

``python -m repro_torch.obs.trace validate out.json`` checks the exported
schema; ``summary`` adds the time per span name, the host spans' and the
device track's apart, and the chunks' counters summed (``syncs``,
``mallocs``, ``split_gemms``, ``split_gemms_transposed`` ...).
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["now", "Tracer", "NullTracer", "NULL_TRACER", "CudaEvents",
           "install", "uninstall", "get", "latest", "paused", "span",
           "instant", "timed", "clock_offset", "counter_deltas",
           "to_chrome", "write_chrome", "merge_wire", "validate_chrome"]

#: THE tracer clock: monotonic, high-resolution, per-process epoch.
now = time.perf_counter

SCHEMA = "repro.obs.trace/v1"

#: thread labels of device tracks start with this
DEVICE_TRACK = "cuda:"


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

    def span(self, name: str, cat: str = "", device: bool = False, **args):
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "", **args) -> None:
        pass

    def counters(self) -> None:
        return None

    def settle(self) -> None:
        pass

    def export_wire(self, device: bool = False) -> None:
        return None


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


class _DeviceSpan(_Span):
    """A span that also brackets the device work it enqueues with a pair
    of timing events; the pair waits in the tracer until :meth:`settle`."""

    __slots__ = ("_ev0",)

    def __enter__(self):
        self._t0 = now()
        self._ev0 = self._tr._record_event()
        return self

    def __exit__(self, *exc):
        t1 = now()
        tr = self._tr
        ev1 = tr._record_event()
        tr._record(self._name, self._cat, self._t0, t1, self._args)
        with tr._lock:
            tr._pending.append((self._name, self._cat, self._ev0, ev1,
                                self._args))
        return False


#: the warning PyTorch gives for a synchronising call under
#: ``set_sync_debug_mode("warn")``
SYNC_WARNING = "called a synchronizing CUDA operation"


class CudaEvents:
    """The device side of a :class:`Tracer`: CUDA timing events on the
    current stream, the caching allocator's statistics and PyTorch's
    sync-debug mode.  A test hands the tracer an object with these methods
    in its place."""

    def ready(self) -> bool:
        """Whether device spans record events: CUDA initialised and the
        current stream not capturing a graph."""
        return (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing())

    def new(self):
        return torch.cuda.Event(enable_timing=True)

    def record(self, ev) -> None:
        ev.record()

    def done(self, ev) -> bool:
        return ev.query()

    def wait(self, ev) -> None:
        ev.synchronize()

    def ms(self, a, b) -> float:
        """Milliseconds from event ``a`` to event ``b``."""
        return a.elapsed_time(b)

    def label(self) -> str:
        return f"{DEVICE_TRACK}{torch.cuda.current_device()}"

    def alloc_stats(self) -> dict:
        return torch.cuda.memory_stats()

    def sync_mode(self, mode=None):
        """The sync-debug mode; with ``mode``, set it and return the old."""
        old = torch.cuda.get_sync_debug_mode()
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        return old


class _SyncCounter:
    """Counts the host synchronisations PyTorch reports in ``warn`` mode.
    Its warnings are counted and never shown; other warnings pass on."""

    _PATTERN = re.escape(SYNC_WARNING)

    def __init__(self, events):
        self.n = 0
        self._events = events
        self._mode = events.sync_mode("warn")
        self._show = warnings.showwarning
        # "always": a sync repeated at one line is counted every time
        warnings.filterwarnings("always", message=self._PATTERN)
        warnings.showwarning = self._count

    def _count(self, message, category, filename, lineno, file=None,
               line=None):
        if SYNC_WARNING in str(message):
            self.n += 1
            return
        self._show(message, category, filename, lineno, file, line)

    def stop(self) -> None:
        self._events.sync_mode(self._mode)
        if warnings.showwarning == self._count:
            warnings.showwarning = self._show
        for f in list(warnings.filters):
            if f[0] == "always" and getattr(f[1], "pattern",
                                            None) == self._PATTERN:
                warnings.filters.remove(f)
                getattr(warnings, "_filters_mutated", lambda: None)()
                break


def counter_deltas(before: dict, after: dict) -> dict:
    """What each counter of :meth:`Tracer.counters` moved between two
    readings (the keys both hold)."""
    return {k: after[k] - before[k] for k in before if k in after}


class Tracer:
    """Preallocated-ring span recorder for one process.

    ``capacity`` bounds memory: a span is 28 bytes of ring columns plus one
    list slot for its (usually ``None``) args dict.  When full, the oldest
    spans are overwritten and ``dropped`` counts them.  At most
    ``capacity`` device spans wait for :meth:`settle`; past that a device
    span records its host interval only.  ``events`` is the device side
    (:class:`CudaEvents` by default).
    """

    enabled = True

    def __init__(self, process: str, capacity: int = 1 << 16, events=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.process = process
        self.events = CudaEvents() if events is None else events
        self._pool: list = []      # timing events free for reuse
        self._pending: list = []   # (name, cat, ev0, ev1, args) to settle
        self._device_tids: set = set()
        self._syncs: Optional[_SyncCounter] = None
        self.pid = os.getpid()
        self.capacity = capacity
        #: seconds ADDED to every timestamp at export: the estimated offset
        #: of this clock to the merge-reference (server) clock.
        self.offset = 0.0
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

    def span(self, name: str, cat: str = "", device: bool = False, **args):
        """Context manager timing one span; ``**args`` become the Chrome
        event's ``args`` payload (JSON-serializable values only).  With
        ``device=True`` the device interval of the work enqueued inside it
        is recorded too, at the next :meth:`settle`."""
        if (device and len(self._pending) < self.capacity
                and self.events.ready()):
            return _DeviceSpan(self, name, cat, args or None)
        return _Span(self, name, cat, args or None)

    def _record_event(self):
        ev = self._pool.pop() if self._pool else self.events.new()
        self.events.record(ev)
        return ev

    def settle(self) -> None:
        """Record the device intervals of the finished device spans.

        Call it right after a host sync, when the device has drained (it
        waits for the stream first, a no-op there): an anchor event
        recorded on the idle device runs at once, so its host time is the
        clock read beside it, and each event's time is the anchor's less
        its distance to the anchor.  Anchoring anew at every call keeps the
        drift between the two clocks to that of one call's span of time.
        Events go back to the pool; pairs whose work has not finished wait
        for the next call."""
        if not self._pending:
            return
        ev = self.events
        anchor = self._pool.pop() if self._pool else ev.new()
        ev.record(anchor)
        ev.wait(anchor)
        h0 = now()
        ev.record(anchor)
        h1 = now()
        ev.wait(anchor)
        err = {"anchor_err_us": round((now() - h0) * 1e6, 3)}
        label = ev.label()
        with self._lock:
            pending, self._pending = self._pending, []
        keep = []
        for item in pending:
            name, cat, e0, e1, args = item
            if not ev.done(e1):
                keep.append(item)
                continue
            self._record(name, cat, h1 - ev.ms(e0, anchor) / 1e3,
                         h1 - ev.ms(e1, anchor) / 1e3,
                         {**args, **err} if args else err, track=label)
            self._pool += (e0, e1)
        self._pool.append(anchor)
        if keep:
            with self._lock:
                self._pending[:0] = keep

    def counters(self) -> Optional[dict]:
        """Cumulative counts for a chunk's args (``None`` without an
        initialised device): ``syncs``, the host synchronisations since the
        first call; ``mallocs``, the caching allocator's ``cudaMalloc`` +
        ``cudaFree`` calls; ``alloc_retries``, its retries after a failed
        allocation; and every count of ``kernels/_build.COUNTS``.
        :func:`counter_deltas` of two readings gives what happened between
        them."""
        if not self.events.ready():
            return None
        if self._syncs is None:
            self._syncs = _SyncCounter(self.events)
        out = {"syncs": self._syncs.n}
        st = self.events.alloc_stats()
        if "num_device_alloc" in st and "num_device_free" in st:
            out["mallocs"] = st["num_device_alloc"] + st["num_device_free"]
        if "num_alloc_retries" in st:
            out["alloc_retries"] = st["num_alloc_retries"]
        out.update(_build.COUNTS)
        return out

    def _stop_counters(self) -> None:
        if self._syncs is not None:
            self._syncs.stop()
            self._syncs = None

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

    def _record(self, name, cat, t0, t1, args, track=None) -> None:
        """One span; ``track`` names a device track (else this thread's)."""
        th = None if track is not None else threading.current_thread()
        key = track if th is None else th.ident
        with self._lock:
            tid = self._tid_of.get(key)
            if tid is None:
                tid = len(self._tids)
                self._tids.append(track if th is None else th.name)
                self._tid_of[key] = tid
                if th is None:
                    self._device_tids.add(tid)
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

    # -- export -----------------------------------------------------------

    def export_wire(self, device: bool = False) -> dict:
        """This tracer's spans as a wire-able bundle (numpy arrays + string
        tables): what a worker ships in its BYE frame.  Timestamps stay in
        the local clock; ``offset`` travels alongside so the merge maps
        them onto the reference timebase.  The host spans only, unless
        ``device`` adds the device track (its records are spans like any
        other, on their own ``tid``)."""
        with self._lock:
            k = self.n_spans
            if self._n > self.capacity:
                h = self._n % self.capacity  # oldest-first ring order
                order = np.concatenate([np.arange(h, self.capacity),
                                        np.arange(h)])
            else:
                order = np.arange(k)
            if not device and self._device_tids:
                order = order[~np.isin(self._tid_ix[order],
                                       list(self._device_tids))]
            args = [self._args[i] for i in order]
            return {
                "schema": SCHEMA,
                "process": self.process,
                "pid": int(self.pid),
                "offset": float(self.offset),
                "dropped": int(self.dropped),
                "names": list(self._names),
                "tids": list(self._tids),
                "t0": self._t0[order].copy(),
                "t1": self._t1[order].copy(),
                "name_ix": self._name_ix[order].copy(),
                "cat_ix": self._cat_ix[order].copy(),
                "tid_ix": self._tid_ix[order].copy(),
                "args_json": json.dumps(args),
            }


# ---------------------------------------------------------------------------
# module-level current tracer
# ---------------------------------------------------------------------------

_TRACER: Any = NULL_TRACER
_LATEST: Optional[Tracer] = None
_INSTALL_LOCK = threading.Lock()


def install(process: str, capacity: int = 1 << 16) -> Tracer:
    """Enable tracing for this process; returns the installed tracer.

    Idempotent: if a tracer is already installed (e.g. the in-process
    threaded runtime, where server and worker share one process), the
    existing one is returned and keeps its name -- the merge dedupes
    bundles by pid, so shared-process spans are never double-counted.
    """
    global _TRACER, _LATEST
    with _INSTALL_LOCK:
        if isinstance(_TRACER, Tracer):
            return _TRACER
        _TRACER = _LATEST = Tracer(process, capacity)
        return _TRACER


def uninstall() -> Optional[Tracer]:
    """Disable tracing; returns the tracer that was installed (if any),
    with the sync-debug mode its counters set restored."""
    global _TRACER
    with _INSTALL_LOCK:
        old, _TRACER = _TRACER, NULL_TRACER
        if not isinstance(old, Tracer):
            return None
        old._stop_counters()
        return old


def get():
    """The current tracer (:data:`NULL_TRACER` when disabled)."""
    return _TRACER


@contextlib.contextmanager
def paused():
    """No spans in this block, from any thread: a shape-only pass of a
    round's code runs in one, and its spans would time no work."""
    global _TRACER
    with _INSTALL_LOCK:
        old, _TRACER = _TRACER, NULL_TRACER
    try:
        yield
    finally:
        with _INSTALL_LOCK:
            if _TRACER is NULL_TRACER:
                _TRACER = old


def latest() -> Optional[Tracer]:
    """The tracer most recently installed in this process, kept after
    :func:`uninstall` so that what it recorded can be read once tracing is
    off (``None`` before the first :func:`install`)."""
    return _LATEST


def span(name: str, cat: str = "", **args):
    """``get().span(...)`` -- the one-liner instrumentation sites use."""
    return _TRACER.span(name, cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    _TRACER.instant(name, cat, **args)


class timed:
    """Measure elapsed seconds on the tracer clock, AND record a span when
    tracing is enabled.  The measurement is unconditional -- this is the
    drop-in replacement for the repo's ad-hoc ``time.time()`` timers::

        with trace.timed("dryrun/compile", "launch") as tm:
            compiled = lowered.compile()
        report["t_compile"] = tm.seconds
    """

    def __init__(self, name: str, cat: str = "", **args):
        self.name = name
        self.cat = cat
        self.args = args or None
        self.seconds = 0.0

    def __enter__(self):
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        t1 = now()
        self.seconds = t1 - self.t0
        tr = _TRACER
        if tr.enabled:
            tr._record(self.name, self.cat, self.t0, t1, self.args)
        return False


def clock_offset(t_send: float, t_recv: float, peer_now: float) -> float:
    """Estimated offset mapping THIS clock onto a peer's, from one
    request/response exchange: the peer stamped ``peer_now`` between our
    ``t_send`` and ``t_recv``, so (assuming symmetric latency) the peer's
    clock read ``peer_now`` at our midpoint.  ``local_t + offset`` is then
    the peer timebase.  The error bound is half the round-trip."""
    return float(peer_now) - 0.5 * (float(t_send) + float(t_recv))


# ---------------------------------------------------------------------------
# Chrome trace-event assembly (the merge)
# ---------------------------------------------------------------------------


def merge_wire(bundles: list) -> list:
    """Dedupe + order wire bundles for :func:`to_chrome`: drops ``None``
    entries and same-pid duplicates (the in-process threaded runtime ships
    the one shared tracer from both ends)."""
    out, seen = [], set()
    for b in bundles:
        if b is None:
            continue
        pid = int(b["pid"])
        if pid in seen:
            continue
        seen.add(pid)
        out.append(b)
    return out


def to_chrome(bundles: list) -> dict:
    """Merge wire bundles into one Chrome trace-event document.

    Every bundle's timestamps are shifted by its ``offset`` (seconds) onto
    the shared reference timebase, then rebased so the earliest span starts
    at ts=0.  Events are complete-events (``ph: "X"``, microseconds), plus
    ``process_name`` / ``thread_name`` metadata rows -- the format Perfetto
    and chrome://tracing load directly.
    """
    bundles = merge_wire(bundles)
    base = None
    for b in bundles:
        if len(b["t0"]):
            lo = float(np.min(np.asarray(b["t0"], np.float64))) + b["offset"]
            base = lo if base is None else min(base, lo)
    base = base or 0.0
    events: list = []
    for b in bundles:
        pid = int(b["pid"])
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": str(b["process"])}})
        for tid, label in enumerate(b["tids"]):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": str(label)}})
        t0 = np.asarray(b["t0"], np.float64) + (b["offset"] - base)
        t1 = np.asarray(b["t1"], np.float64) + (b["offset"] - base)
        names, name_ix = b["names"], np.asarray(b["name_ix"])
        cat_ix = np.asarray(b["cat_ix"])
        tid_ix = np.asarray(b["tid_ix"])
        args = json.loads(b["args_json"]) if isinstance(
            b.get("args_json"), (str, bytes)) else (b.get("args")
                                                    or [None] * len(t0))
        for i in range(len(t0)):
            ev = {"name": names[int(name_ix[i])],
                  "cat": names[int(cat_ix[i])] or "default",
                  "ph": "X",
                  "ts": round(t0[i] * 1e6, 3),
                  "dur": round(max(t1[i] - t0[i], 0.0) * 1e6, 3),
                  "pid": pid, "tid": int(tid_ix[i])}
            if args[i]:
                ev["args"] = args[i]
            events.append(ev)
    return {"schema": SCHEMA, "displayTimeUnit": "ms",
            "traceEvents": events,
            "metadata": {"dropped": {str(b["process"]): int(b["dropped"])
                                     for b in bundles}}}


def write_chrome(doc: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return path


# ---------------------------------------------------------------------------
# schema validation (tests + the CI smoke job)
# ---------------------------------------------------------------------------


def validate_chrome(doc) -> list:
    """Problems with a Chrome trace-event document; empty list == valid.

    Checks the event schema (required keys, numeric non-negative ts/dur)
    and the structural invariant the merge promises: within one (pid, tid)
    track, complete-events are properly nested -- any two spans are either
    disjoint or one contains the other (Perfetto renders partial overlap
    as garbage stacks).
    """
    errs: list = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["not a trace document: expected {'traceEvents': [...]}"]
    tracks: dict = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "i"):
            errs.append(f"event {i}: unsupported ph {ph!r}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in ev:
                errs.append(f"event {i}: missing {key!r}")
        if ph == "M":
            if not isinstance(ev.get("args"), dict) or "name" not in ev["args"]:
                errs.append(f"event {i}: metadata row without args.name")
            continue
        ts, dur = ev.get("ts"), ev.get("dur", 0)
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i}: bad ts {ts!r}")
            continue
        if not isinstance(dur, (int, float)) or dur < 0:
            errs.append(f"event {i}: bad dur {dur!r}")
            continue
        if ph == "X":
            tracks.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (float(ts), float(ts) + float(dur), i))
    for (pid, tid), spans in tracks.items():
        # sort by start, longest first at ties, then check stack nesting
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list = []
        for t0, t1, i in spans:
            while stack and stack[-1][1] <= t0 + 1e-9:
                stack.pop()
            if stack and t1 > stack[-1][1] + 1e-3:  # 1ns slack at µs scale
                errs.append(
                    f"track (pid={pid}, tid={tid}): event {i} "
                    f"[{t0}, {t1}] partially overlaps enclosing span "
                    f"[{stack[-1][0]}, {stack[-1][1]}]")
            stack.append((t0, t1))
    return errs


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.obs.trace validate out.json
# ---------------------------------------------------------------------------


def _totals(evs) -> list:
    """``[(name, (seconds, spans))]``, most seconds first."""
    by_name: dict = {}
    for e in evs:
        tot, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (tot + e.get("dur", 0) / 1e6, n + 1)
    return sorted(by_name.items(), key=lambda kv: -kv[1][0])


def chunk_counters(evs) -> dict:
    """The counters of the ``exec/chunk`` spans among ``evs``, each summed
    over the chunks (every numeric arg but ``start_round`` and
    ``rounds``), and ``rounds``, the rounds they cover."""
    out: dict = {}
    for e in evs:
        if e.get("name") != "exec/chunk":
            continue
        for k, v in e.get("args", {}).items():
            if k != "start_round" and isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + v
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="trace tooling (see module docstring)")
    ap.add_argument("cmd", choices=["validate", "summary"])
    ap.add_argument("path")
    ns = ap.parse_args(argv)
    with open(ns.path) as f:
        doc = json.load(f)
    errs = validate_chrome(doc)
    if errs:
        for e in errs:
            print(f"INVALID: {e}")
        return 1
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    procs = {e["pid"] for e in evs}
    span_s = sum(e.get("dur", 0) for e in evs) / 1e6
    print(f"valid: {len(evs)} spans across {len(procs)} process(es), "
          f"{span_s:.3f}s total span time")
    if ns.cmd == "summary":
        device = {(e["pid"], e["tid"]) for e in doc["traceEvents"]
                  if e.get("ph") == "M" and e.get("name") == "thread_name"
                  and str(e["args"]["name"]).startswith(DEVICE_TRACK)}
        host = _totals(e for e in evs if (e["pid"], e["tid"]) not in device)
        for name, (tot, n) in host:
            print(f"  {name:<28s} {n:6d} spans  {tot:10.4f}s")
        if device:
            # the device intervals of the same spans, beside their host time
            print(f"  {'device track':<28s} {'host s':>10s} {'device s':>10s}")
            host_s = {name: tot for name, (tot, _n) in host}
            for name, (tot, _n) in _totals(
                    e for e in evs if (e["pid"], e["tid"]) in device):
                print(f"  {name:<28s} {host_s.get(name, 0.0):10.4f} "
                      f"{tot:10.4f}")
        counts = chunk_counters(evs)
        if set(counts) - {"rounds"}:  # the port's engine counted something
            print("  chunk counters: " + ", ".join(
                f"{k} {v}" for k, v in counts.items()))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
