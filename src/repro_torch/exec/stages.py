"""Composable execution stages of the round engine.

The counterpart of :mod:`repro.exec.stages`:

  ============ =========================================================
  stage        concern (and its slice of the engine's carried state)
  ============ =========================================================
  Placement    device-mesh placement: state and stage-state shardings
               from ``FedAlgorithm.state_roles`` and the plan rule tables
               of :mod:`repro_torch.launch.sharding` (no state of its own
               -- it places everyone else's)
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
from the config's stage fields.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch


@dataclass(frozen=True)
class Placement:
    """Mesh placement of the federated state and the other stages' state.

    ``param_specs`` is the logical-axis spec tree of the parameters
    (:mod:`repro_torch.models.axes` gives the model's); ``plan`` is a
    federated placement plan of :mod:`repro_torch.launch.sharding` ("A",
    "A_dp" or "B").  Placement never changes the math -- it composes with
    every other stage but the cohort by placing their state too
    (compressor residuals and report buffers are client-axis trees, so the
    client placement rules already know where they go).
    """

    mesh: Any
    param_specs: Any = None
    plan: str = "A"
    name: str = "placement"

    def state_shardings(self, algorithm, state):
        """NamedShardings for an algorithm's state from its declared
        roles."""
        from repro_torch.launch import sharding as shd

        try:
            roles = algorithm.state_roles()
        except NotImplementedError as e:
            raise ValueError(
                f"algorithm {algorithm.name!r} declares no state placement "
                "(implement FedAlgorithm.state_roles to run under the "
                "placement stage)") from e
        return shd.fed_state_shardings_from_roles(
            self.mesh, roles, state, self.param_specs, self.plan)

    def client_sharding(self, n_clients: int):
        """The sharding of a ``(n_clients,)`` client axis: where each
        rank's clients are."""
        from repro_torch.launch import sharding as shd

        return shd.carry_slice_shardings(
            self.mesh, torch.empty((n_clients,), device="meta"), self.plan,
            n_clients, client_axis=0)

    def carry_shardings(self, extras: dict, n_clients: int):
        """Placement for the other stages' state slices.

        Each slice's client axis is declared structurally: compressor state
        is message-shaped (client axis 0), the one-slot report buffer is
        client-major, the queued buffer stacks a leading queue-depth axis
        (client axis 1) -- except its per-client residual/ledger fields --
        and the downlink shadow replicates.  Under the flat layout
        (``EngineConfig(plane=True)``) the message-shaped slices are
        ``(n_clients, d_pad)`` planes (queued: ``(depth, n_clients,
        d_pad)``): one spec per slice.
        """
        from repro_torch.launch import sharding as shd

        def place(tree, axis):
            return shd.carry_slice_shardings(self.mesh, tree, self.plan,
                                             n_clients, client_axis=axis)

        axes = {"comm": 0, "key": None, "dl": None}
        out = {}
        for name, slice_ in extras.items():
            if name == "sched":
                out[name] = self._sched_shardings(slice_, place)
            else:
                out[name] = place(slice_, axes.get(name, None))
        return out

    def _sched_shardings(self, sched, place):
        from repro_torch.sched import QueueState

        queued = isinstance(sched, QueueState)
        per_field = {
            # message/aux buffers gain a leading queue axis when queued
            "pending_msg": 1 if queued else 0,
            "pending_aux": 1 if queued else 0,
            "slot_filled": 1, "deliver_time": 1 if queued else 0,
            # per-client fields stay client-major in both layouts
            "resid": 0, "need_refresh": 0, "last_synced": 0, "last_age": 0,
            # scalars replicate
            "vtime": None, "round_idx": None, "clock_key": None,
        }
        return type(sched)(**{
            f: place(getattr(sched, f), per_field.get(f))
            for f in sched._fields})


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

    placement: Optional[Placement] = None
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
        return tuple(s.name for s in (self.placement, self.uplink,
                                      self.downlink, self.asynchrony,
                                      self.cohort)
                     if s is not None)


def sink_blockers(stack: StageStack, *, participation: bool, jit: bool,
                  kind: str) -> Tuple[str, ...]:
    """Stage names that make a per-chunk engine sink of ``kind``
    unsupported (empty tuple = the sink composes with this stack); the
    reference's rule, stage for stage.

    ``"uplink"`` taps the compressed uplink messages on the round's
    straight line, so anything that re-routes the uplink off it blocks
    it: asynchrony (report buffers), cohort residency, partial
    participation, placement, and the eager path (``jit=False``).

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
    if stack.placement is not None:
        blockers.append("placement")
    if not jit:
        blockers.append("jit=False")
    return tuple(blockers)
