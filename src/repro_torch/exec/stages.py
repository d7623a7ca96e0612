"""Composable execution stages of the round engine.

The counterpart of :mod:`repro.exec.stages`, without the placement stage:

  ============ =========================================================
  stage        concern (and its slice of the engine's carried state)
  ============ =========================================================
  UplinkComm   the client->server message through a
               :mod:`repro_torch.comm` Transport (error-feedback residuals)
  DownlinkComm the server->client broadcast through a
               :class:`repro_torch.comm.DownlinkCompressor` (the
               client-visible shadow state)
  Asynchrony   simulated client asynchrony via :mod:`repro_torch.sched`
               (the in-flight report buffer or queue + staleness ledger;
               optionally a client->edge->root tree via ``edges``)
  Cohort       cohort-resident client state
               (:mod:`repro_torch.sched.cohort`): per-client state is
               cohort-wide on the device, gathered from and scattered to a
               host population store at chunk boundaries
  ============ =========================================================

:meth:`repro_torch.exec.EngineConfig.resolve` builds a :class:`StageStack`
from the config's stage fields.  The reference's Placement stage is not
ported yet: ``mesh=`` raises, naming the slice that brings it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class UplinkComm:
    """Client->server transport on the uplink message.

    ``transport=None`` resolves to the identity :class:`repro_torch.comm.Dense`
    (the stage still splits the round into its local/server halves, which
    the downlink stage builds on).
    """

    transport: Any = None
    name: str = "uplink"

    def resolve_transport(self):
        if self.transport is None:
            from repro_torch.comm import Dense

            return Dense()
        return self.transport


@dataclass(frozen=True)
class DownlinkComm:
    """Server->client broadcast compression (shadow-state error feedback)."""

    compressor: Any
    name: str = "downlink"

    @classmethod
    def coerce(cls, obj) -> "DownlinkComm":
        """Accept a DownlinkCompressor or a plain Transport (wrapped)."""
        if isinstance(obj, DownlinkComm):
            return obj
        if not hasattr(obj, "broadcast"):  # plain Transport
            from repro_torch.comm import DownlinkCompressor

            obj = DownlinkCompressor(obj)
        return cls(obj)


@dataclass(frozen=True)
class Asynchrony:
    """Simulated client asynchrony: virtual-time clock, buffered commits,
    staleness weighting, and optionally a ``queue_depth``-deep per-client
    report queue (``None`` keeps the one-slot buffer)."""

    clock: Any = None
    buffer_size: Optional[int] = None
    staleness: Any = None
    queue_depth: Optional[int] = None
    name: str = "asynchrony"
    # client->edge->root aggregation tree (None/1: flat selection)
    edges: Optional[int] = None

    def resolve_clock(self):
        from repro_torch.sched import DeterministicClock, get_clock

        clock = self.clock
        if clock is None:
            clock = DeterministicClock()
        elif isinstance(clock, str):
            clock = get_clock(clock)
        if not hasattr(clock, "durations"):
            raise ValueError(
                f"clock must implement the repro_torch.sched.ClockModel "
                f"interface (durations), got {type(clock).__name__}")
        return clock

    def resolve_staleness(self):
        from repro_torch.sched import as_staleness

        return as_staleness(self.staleness)


@dataclass(frozen=True)
class Cohort:
    """Cohort-resident client state (:mod:`repro_torch.sched.cohort`).

    Lives at the chunk boundary: the engine's per-client state (algorithm
    client fields, error-feedback residuals, report buffers) is cohort-wide
    on the device, and this stage gathers and scatters it against the host
    population store between chunks.  ``cohort == population`` is the
    dense engine, bitwise.
    """

    population: Optional[int] = None  # None: the engine's n_clients
    cohort: Optional[int] = None      # None: the full population
    seed: int = 0
    name: str = "cohort"

    def spec(self, n_clients: int):
        """The resolved :class:`repro_torch.sched.cohort.CohortSpec` for an
        engine with ``n_clients`` clients (the population)."""
        from repro_torch.sched.cohort import CohortSpec

        population = (self.population if self.population is not None
                      else n_clients)
        spec = CohortSpec(population,
                          self.cohort if self.cohort is not None
                          else population, self.seed)
        spec.validate()
        return spec


@dataclass(frozen=True)
class StageStack:
    """The resolved, validated stage combination one engine runs.

    ``protocol=True`` is the one non-composable mode: the literal
    per-client message-passing form of Algorithm 1, kept for equivalence
    testing.
    """

    uplink: Optional[UplinkComm] = None
    downlink: Optional[DownlinkComm] = None
    asynchrony: Optional[Asynchrony] = None
    cohort: Optional[Cohort] = None
    protocol: bool = False

    @property
    def split(self) -> bool:
        """Whether the round runs as local/server halves joined by an
        explicit message exchange (any communication-shaped stage)."""
        return (self.uplink is not None or self.downlink is not None
                or self.asynchrony is not None)

    def names(self) -> Tuple[str, ...]:
        if self.protocol:
            return ("protocol",)
        return tuple(s.name for s in (self.uplink, self.downlink,
                                      self.asynchrony, self.cohort)
                     if s is not None)


def sink_blockers(stack: StageStack, *, participation: bool, jit: bool,
                  kind: str) -> Tuple[str, ...]:
    """Stage names that make a per-chunk engine sink of ``kind``
    unsupported (empty tuple = the sink composes with this stack); the
    reference's rule, stage for stage.

    ``"uplink"`` taps the compressed uplink messages on the round's
    straight line, so anything that re-routes the uplink off it blocks
    it: asynchrony (report buffers), cohort residency, partial
    participation, and the eager path (``jit=False``).  The port has no
    placement stage, so the reference's ``"placement"`` blocker never
    arises.

    ``"snapshot"`` only reads the committed post-chunk state the engine
    already holds at every chunk boundary, so it composes with every
    stage except the protocol form, which bypasses the engine's chunk
    structure entirely.
    """
    if kind == "snapshot":
        return ("protocol",) if stack.protocol else ()
    if kind != "uplink":
        raise ValueError(f"unknown sink kind {kind!r}")
    blockers = []
    if stack.asynchrony is not None:
        blockers.append("asynchrony")
    if stack.cohort is not None:
        blockers.append("cohort")
    if participation:
        blockers.append("participation")
    if not jit:
        blockers.append("jit=False")
    return tuple(blockers)
