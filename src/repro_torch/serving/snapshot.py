"""The serving snapshot plane: versioned, atomically-swapped model planes.

Training commits and inference reads meet here.  A publisher (the round
engine's snapshot sink, or a replica applying wire deltas) calls
:meth:`SnapshotStore.publish`; readers call :meth:`SnapshotStore.latest`.
The two never block each other and a reader never observes a torn plane:

  * every :class:`ServingSnapshot` is **immutable** -- the store never
    writes into a published snapshot's arrays, a publish always builds a
    fresh one;
  * the store's "current" pointer is a single Python reference, swapped
    atomically under the GIL, so ``latest()`` returns either the old
    complete snapshot or the new complete snapshot, nothing in between;
  * the store is **double-buffered**: it retains the current and the
    previous snapshot (older ones are dropped), so a publisher can build
    version ``v+1`` while readers still hold ``v`` -- at no point does a
    commit wait on inference, which is exactly the property the round
    engine's per-chunk sink needs (it fires on the training thread,
    before the chunk's host sync).

Versions are monotonic, assigned by the store.  ``published_at`` rides
:func:`repro_torch.obs.trace.now` so snapshot age at read lands on the same
timebase as the training spans.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.obs import trace as _trace


@dataclass(frozen=True)
class ServingSnapshot:
    """One immutable, versioned serving plane.

    ``value`` is whatever the publisher committed -- typically a params
    pytree (device- or host-resident); by contract nobody mutates it
    after publish.
    """

    version: int
    round: int
    value: Any
    published_at: float = field(default=0.0, compare=False)

    def age(self, now: Optional[float] = None) -> float:
        """Seconds since this snapshot was published (the staleness a
        reader serves at)."""
        return ((_trace.now() if now is None else now)
                - self.published_at)


class SnapshotStore:
    """Monotonically-versioned snapshot exchange between one (or more)
    publishers and any number of readers.

    Thread-safe: ``publish`` serializes on an internal lock (publishers
    are rare -- one per training commit); ``latest`` is a single atomic
    reference read and never takes the lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._current: Optional[ServingSnapshot] = None
        self._previous: Optional[ServingSnapshot] = None  # the double buffer
        self._subscribers: list[Callable[[ServingSnapshot], None]] = []

    # -- publisher side ---------------------------------------------------

    def publish(self, value, round: int = -1) -> ServingSnapshot:
        """Install ``value`` as the next snapshot version; returns it.

        ``value`` must not be mutated afterwards (the store does not
        copy -- publishing a device-resident pytree straight out of the
        engine's committed state is the point).
        """
        with self._cond:
            version = (self._current.version + 1) if self._current else 1
            snap = ServingSnapshot(version=version, round=int(round),
                                   value=value,
                                   published_at=_trace.now())
            # the swap: one reference assignment; readers holding the old
            # snapshot keep a complete, immutable plane
            self._previous = self._current
            self._current = snap
            subs = list(self._subscribers)
            self._cond.notify_all()
        _trace.instant("serve/publish", "serve", version=version,
                       round=int(round))
        for cb in subs:
            cb(snap)
        return snap

    def subscribe(self, cb: Callable[[ServingSnapshot], None]) -> None:
        """Call ``cb(snapshot)`` after every publish (on the publisher's
        thread -- keep it cheap or hand off, exactly like an engine sink)."""
        with self._lock:
            self._subscribers.append(cb)

    # -- reader side ------------------------------------------------------

    def latest(self) -> Optional[ServingSnapshot]:
        """The current snapshot (None before the first publish).  Lock-free
        and wait-free: a plain reference read."""
        return self._current

    def previous(self) -> Optional[ServingSnapshot]:
        """The retained prior snapshot (the second buffer), if any."""
        return self._previous

    @property
    def version(self) -> int:
        snap = self._current
        return 0 if snap is None else snap.version

    def wait_for(self, version: int,
                 timeout: Optional[float] = None) -> Optional[ServingSnapshot]:
        """Block until a snapshot with ``version`` or newer exists; returns
        it (None on timeout)."""
        deadline = None if timeout is None else _trace.now() + timeout
        with self._cond:
            while self._current is None or self._current.version < version:
                remaining = (None if deadline is None
                             else deadline - _trace.now())
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            return self._current

    # -- engine glue ------------------------------------------------------

    def engine_sink(self, select: Optional[Callable[[Any], Any]] = None):
        """A callable for a round engine's snapshot sink
        (:meth:`repro_torch.exec.RoundEngine.set_snapshot_sink`).

        The engine fires ``sink(end_round, state)`` per committed chunk
        with the full (device-resident) algorithm state; ``select`` maps
        it to the published value -- e.g. ``lambda s: global_params(reg,
        fcfg, s)`` for an LM, or ``None`` to publish the server-role
        fields dict the engine already extracted.
        """
        def sink(end_round: int, state) -> None:
            value = state if select is None else select(state)
            self.publish(value, round=end_round)

        return sink
