"""The round-execution engine.

The counterpart of :class:`repro.exec.RoundEngine` with its placement,
communication, asynchrony and cohort stages (:mod:`repro_torch.exec.stages`).
It runs one (algorithm, grad_fn, n_clients) triple round after round.

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

With no stage active a round is the algorithm's ``round_fn``.  With the
UplinkComm stage (``transport=``) or the DownlinkComm stage (``downlink=``)
the round is *split*, as the reference's compiled scan body: the local
half, then ``transport.compress`` of the uplink message, then (under
participation) ``select_clients`` on the error feedback, then the server
half, then ``downlink.broadcast`` of the new server state.  Clients compute
against the downlink shadow; the server state stays authoritative.

With the Asynchrony stage (``clock=``, ``buffer_size=``, ``staleness=``,
``queue_depth=``, ``edges=``) one round is one buffered server commit of
:func:`repro_torch.sched.make_async_round`, and the metrics gain the
staleness ledger: ``vtime``, ``staleness_mean``, ``staleness_max`` and the
``report_age_hist`` vector.

``plane=True`` carries the message, its error feedback and the async report
buffers (queues) as ``(n_clients, d_pad)`` (``(depth, n_clients, d_pad)``)
planes; the server half's weighted client-axis sum then runs as one launch
of the weighted-commit kernel on the delivered plane.

With the Cohort stage (``population=``, ``cohort=``) the per-client state is
cohort-wide on the device and swapped against a host
:class:`repro_torch.sched.PopulationStore` at chunk boundaries.

With the Placement stage (``mesh=``, ``param_specs=``, ``plan=``) the state
and the stages' state live as DTensors on the mesh, placed by the rule
tables of :mod:`repro_torch.launch.sharding` (clients over 'data', params
over 'model' in plan A) and the round is one SPMD program over the mesh's
ranks, with its collectives explicit:

  * the downlink -- each field is gathered to full on every rank (an
    all-gather over the axes that shard it);
  * the local half -- each rank runs the algorithm's local half on ITS
    clients only (the rows the client placement gives it) and the batches'
    same rows, with the kernels on plain local tensors;
  * the uplink -- the clients' messages and aux are all-gathered over the
    client axes, so every rank holds every client's report;
  * the rest of the round (compression, the async buffer, the server
    half, the downlink broadcast) runs on the full client axis, the same on
    every rank, and the new state is placed again (each rank keeps its
    block: a slice, no communication).

Every algorithm runs its local and server halves under placement (all seven
have them), so a placed round is the unplaced round's arithmetic op for
op: on one rank bitwise, on several in the same order too.  Placement
composes with every stage but the cohort (the reference refuses that too)
and the uplink sink.

``protocol=True`` runs the algorithm's literal per-client message-passing
round (``make_protocol_round_fn``; DProx has one) and composes with no
stage, no participation and no plane.

Two per-chunk sinks hand the engine's output on without a host sync of
their own (:meth:`RoundEngine.set_uplink_sink`, the multi-process
runtime's uplink; :meth:`RoundEngine.set_snapshot_sink`, serving
snapshots): both fire after a chunk's rounds are enqueued and before the
chunk's one host sync.

Spans (:mod:`repro_torch.obs.trace`; free while no tracer is installed).
Those marked * also record the device interval of the work they enqueue
(on the tracer's device track, at :meth:`Tracer.settle`, which ``run``
calls after each chunk's host sync):

  * ``exec/chunk`` -- one chunk, with the args ``start_round``, ``rounds``
    and, on an initialised CUDA device, the chunk's counters: ``syncs``
    (host synchronisations: the chunk's own, and any other, such as a
    batch's copy from pageable host memory), ``mallocs`` (the caching
    allocator's ``cudaMalloc`` + ``cudaFree`` calls, each a device sync)
    and ``alloc_retries``;
  * ``exec/supply`` * -- the chunk's batches (``sample_chunk``, or per
    round ``sample_round`` and the participation mask; the cohort's), and
    each round's move of its batches and mask to the device;
  * ``exec/local`` * -- the local half (the algorithm's ``local/grad`` *
    and DProx's ``local/update`` * per local step nest in it);
  * ``exec/compress`` * -- the uplink's ``transport.compress``;
  * ``exec/server`` * -- the server half, the commit;
  * ``exec/broadcast`` * -- ``downlink.broadcast``;
  * ``exec/async_round`` * -- one buffered commit of the asynchrony stage;
  * ``exec/snapshot_publish`` -- the snapshot sink;
  * ``exec/host_sync`` -- the chunk's one host sync.

Without a split the round is the algorithm's ``round_fn``, which opens
``exec/local`` and ``exec/server`` itself.

The stages' state (``comm``: error feedback, ``dl``: the shadow, ``sched``:
the report buffer) lives on the engine and persists across ``run``/``step``
calls.  It is built before the first round from the message's shapes, which
a shape-only pass of the local half on fake tensors gives
(:func:`repro_torch.device.eval_shape`, the reference's ``jax.eval_shape``).

Draws: the reference splits ``jax.random`` keys; the port's stochastic
compressors consume ONE draw source (``draws=``, by default a
``torch.Generator`` on the engine's device seeded with ``comm_seed``) in a
fixed order: per round, the uplink's draws (leaves in ``jax.tree_util``
order, rows in order), then the downlink's.  The clock draws from its own
source (``clock_draws=``, by default seeded with ``clock_seed``).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import plane as pln
from repro_torch.device import eval_shape, resolve_device, to_device
from repro_torch.exec.stages import (Asynchrony, Cohort, DownlinkComm,
                                     Placement, StageStack, UplinkComm,
                                     sink_blockers)
from repro_torch.exec.suppliers import (as_supplier, has_chunk_path,
                                        supports_client_ids)
from repro_torch.obs import trace as _trace
from repro_torch.utils import tree as tu

def server_state_fields(algorithm, state) -> dict:
    """The 'server'-role fields of an algorithm's state: the broadcast
    pytree a :class:`repro_torch.comm.DownlinkCompressor` operates on."""
    roles = algorithm.state_roles()
    return {k: getattr(state, k) for k, r in roles.items() if r == "server"}


@dataclass(frozen=True)
class EngineConfig:
    """Execution options -- orthogonal to the algorithm being run.

    chunk_rounds   : rounds run between two host syncs of the metrics.
    participation  : if set, the fraction of clients active each round
                     (uniform sampling without replacement, >= 1 client).
                     Requires a round function with an ``active`` argument;
                     does not compose with asynchrony or cohorts.
    plane          : carry the uplink message, its error feedback and the
                     async report buffers as flat ``(n_clients, d_pad)``
                     planes (:mod:`repro_torch.core.plane`).  A no-op
                     without a communication stage; requires a single-dtype
                     message.

    UplinkComm stage (active when ``transport`` is set, or implicitly under
    any other communication-shaped stage, defaulting to Dense):
    transport      : the uplink compressor (:mod:`repro_torch.comm`).
    comm_seed      : seed of the default draw source.

    DownlinkComm stage (active when ``downlink`` is set):
    downlink       : a :class:`repro_torch.comm.DownlinkCompressor` (or a
                     plain Transport, which gets wrapped).

    Asynchrony stage (active when any of its fields is set):
    clock          : a :mod:`repro_torch.sched` ClockModel (or its name);
                     defaults to the zero-delay DeterministicClock.
    buffer_size    : reports the server waits for before committing
                     (FedBuff's K); defaults to the working client count.
    staleness      : a :class:`repro_torch.sched.Staleness` (or "uniform",
                     "poly").
    queue_depth    : depth of the per-client report queue (``None``: the
                     one-slot buffer; 1 is its queue-form equivalent).
    clock_seed     : seed of the clock's default draw source.
    edges          : the client->edge->root tree of the arrival selection
                     and the commit normalization; must divide the working
                     client width.

    Cohort stage (active when ``population`` or ``cohort`` is set):
    population     : total simulated clients; the engine's ``n_clients``
                     IS the population, so both must agree when given.
    cohort         : the working-set width per chunk (defaults to the
                     population; ``cohort == population`` is the dense
                     engine, bitwise).
    cohort_seed    : seed of the per-chunk cohort id draws.

    Placement stage (active when ``mesh`` is set):
    mesh/param_specs/plan : the device mesh
                     (:mod:`repro_torch.launch.mesh`), the logical-axis spec
                     tree of the parameters and the federated placement
                     plan ("A", "A_dp" or "B").  The engine's device must be
                     the mesh's device type.

    protocol       : the literal per-client message-passing form of
                     Algorithm 1 (equivalence testing); composes with no
                     stages.
    """

    chunk_rounds: int = 1
    participation: Optional[float] = None
    plane: bool = False
    transport: Any = None
    comm_seed: int = 0
    downlink: Any = None
    mesh: Any = None
    param_specs: Any = None
    plan: str = "A"
    clock: Any = None
    buffer_size: Optional[int] = None
    staleness: Any = None
    queue_depth: Optional[int] = None
    clock_seed: int = 0
    edges: Optional[int] = None
    population: Optional[int] = None
    cohort: Optional[int] = None
    cohort_seed: int = 0
    protocol: bool = False

    def resolve(self) -> StageStack:
        """Validate and map this config onto its :class:`StageStack`."""
        if self.chunk_rounds < 1:
            raise ValueError(
                f"chunk_rounds must be >= 1, got {self.chunk_rounds}")
        if self.participation is not None and not (
                0.0 < self.participation <= 1.0):
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")
        placement_on = self.mesh is not None
        async_on = (self.clock is not None or self.buffer_size is not None
                    or self.staleness is not None
                    or self.queue_depth is not None or self.edges is not None)
        cohort_on = self.population is not None or self.cohort is not None
        downlink_on = self.downlink is not None
        uplink_on = self.transport is not None or async_on or downlink_on
        if cohort_on:
            if self.protocol:
                raise ValueError(
                    "cohort-resident state does not apply to the protocol "
                    "mode (literal per-client message passing has no "
                    "fixed-width working set)")
            if self.participation is not None:
                raise ValueError(
                    "cohort-resident state subsumes participation: the "
                    "sampled cohort IS the participating subset (set "
                    "cohort < population instead of a participation "
                    "fraction)")
            if placement_on:
                raise ValueError(
                    "cohort-resident state does not compose with the "
                    "placement stage (the reference refuses it too); drop "
                    "mesh= or run the dense engine")
            if self.population is not None and self.population < 1:
                raise ValueError(f"population must be >= 1, got "
                                 f"{self.population}")
            if self.cohort is not None and self.cohort < 1:
                raise ValueError(f"cohort must be >= 1, got {self.cohort}")
            if (self.population is not None and self.cohort is not None
                    and self.cohort > self.population):
                raise ValueError(
                    f"cohort={self.cohort} exceeds population="
                    f"{self.population}; the cohort is the participating "
                    "subset of the population")
        if self.edges is not None and self.edges < 1:
            raise ValueError(f"edges must be >= 1, got {self.edges}")
        if self.protocol:
            if self.participation is not None:
                raise ValueError("the protocol mode does not support "
                                 "partial participation")
            if self.plane:
                raise ValueError("plane mode does not apply to the protocol "
                                 "mode (literal per-client message passing)")
            if placement_on or uplink_on:
                raise ValueError(
                    "the protocol mode (literal per-client message passing) "
                    "composes with no stages; drop the "
                    "mesh/transport/downlink/clock options or run them on "
                    "the staged engine")
            return StageStack(protocol=True)
        if placement_on and self.param_specs is None:
            raise ValueError(
                "the placement stage requires param_specs: the logical-axis "
                "spec tree of the parameters, matching the params tree leaf "
                "for leaf (e.g. {'w': ('mlp',), 'b': ()}; "
                "repro_torch.models.axes.param_specs gives a model's)")
        if self.transport is not None and not hasattr(self.transport,
                                                      "compress"):
            raise ValueError(
                "transport must implement the repro_torch.comm.Transport "
                f"interface, got {type(self.transport).__name__}")
        if async_on and self.participation is not None:
            raise ValueError(
                "the asynchrony stage does not compose with participation: "
                "client subsampling is implicit in buffered aggregation "
                "(set buffer_size < n_clients instead)")
        if self.buffer_size is not None and self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got "
                             f"{self.buffer_size}")
        if self.queue_depth is not None and self.queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got "
                             f"{self.queue_depth}")
        return StageStack(
            placement=(Placement(self.mesh, self.param_specs, self.plan)
                       if placement_on else None),
            uplink=UplinkComm(self.transport) if uplink_on else None,
            downlink=(DownlinkComm.coerce(self.downlink)
                      if downlink_on else None),
            asynchrony=(Asynchrony(self.clock, self.buffer_size,
                                   self.staleness, self.queue_depth,
                                   edges=self.edges)
                        if async_on else None),
            cohort=(Cohort(self.population, self.cohort, self.cohort_seed)
                    if cohort_on else None))

    def validate(self, n_clients: Optional[int] = None) -> None:
        """Validate the config; with ``n_clients`` (the population under
        cohort-resident state) also the width-dependent geometry: cohort vs
        population, buffer_size and edges vs the working client width."""
        self.resolve()
        if n_clients is None:
            return
        working = n_clients
        if self.population is not None or self.cohort is not None:
            from repro_torch.sched.cohort import CohortSpec

            if self.population is not None and self.population != n_clients:
                raise ValueError(
                    f"EngineConfig(population={self.population}) disagrees "
                    f"with n_clients={n_clients}; the engine's client count "
                    "IS the population under cohort-resident state")
            working = self.cohort if self.cohort is not None else n_clients
            CohortSpec(n_clients, working, self.cohort_seed).validate()
        if (self.buffer_size is not None or self.edges is not None
                or self.clock is not None or self.staleness is not None
                or self.queue_depth is not None):
            from repro_torch.sched.aggregator import _validate_buffer

            _validate_buffer(
                self.buffer_size if self.buffer_size is not None
                else working, working,
                self.edges if self.edges is not None else 1)


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


def _host_metrics(infos: list) -> list:
    """Per-round ``{name: float | np.ndarray}`` from a chunk's device
    metrics, fetched in ONE host copy (0-dim metrics become floats, vector
    metrics such as ``report_age_hist`` stay arrays)."""
    if not infos or not infos[0]:
        return [{} for _ in infos]
    keys = list(infos[0])
    shapes = [tuple(infos[0][k].shape) for k in keys]
    flat = torch.cat([info[k].reshape(-1).float() for info in infos
                      for k in keys]).cpu().numpy()
    out, pos = [], 0
    for _ in infos:
        row = {}
        for k, shape in zip(keys, shapes):
            n = int(np.prod(shape))
            v = flat[pos:pos + n]
            row[k] = float(v[0]) if shape == () else v.reshape(shape).copy()
            pos += n
        out.append(row)
    return out


class RoundEngine:
    """Runs federated rounds for one (algorithm, grad_fn, n_clients) triple
    on one device (``cuda`` unless ``device`` says otherwise).

    ``draws`` is the draw source of the stochastic compressors and
    ``clock_draws`` the clock's (see the module docstring); by default
    ``torch.Generator``\\ s on the engine's device seeded with
    ``config.comm_seed`` and ``config.clock_seed``.  Under the cohort stage
    ``n_clients`` is the population and every stage sees the cohort width.
    """

    def __init__(self, algorithm, grad_fn, n_clients: int,
                 config: EngineConfig = EngineConfig(), *, device=None,
                 draws=None, clock_draws=None):
        stack = config.resolve()
        self.algorithm = algorithm
        self.grad_fn = grad_fn
        self.n_clients = n_clients
        self.population = n_clients
        self.config = config
        self.stack = stack
        self.device = resolve_device(device)
        if stack.placement is not None:
            mesh_type = stack.placement.mesh.device_type
            if self.device.type != mesh_type:
                raise ValueError(
                    f"the engine runs on {self.device} but its mesh is over "
                    f"{mesh_type} ranks; pass device={mesh_type!r}")
        self._state_shardings = None
        self.transport = None
        self.downlink = None
        self._cohort = None
        self._cohort_round = 0
        if stack.cohort is not None:
            from repro_torch.sched.cohort import ResidentCohort

            if (stack.cohort.population is not None
                    and stack.cohort.population != n_clients):
                raise ValueError(
                    f"EngineConfig(population={stack.cohort.population}) "
                    f"disagrees with the engine's n_clients={n_clients}; "
                    "the engine's client count IS the population under "
                    "cohort-resident state (pass the same value, or drop "
                    "the population field)")
            self._cohort = ResidentCohort(stack.cohort.spec(n_clients),
                                          device=self.device)
            # every stage below sees the WORKING width
            self.n_clients = self._cohort.spec.cohort
        # per-client wire bytes of one uplink message / one broadcast, known
        # once the stages' state is built
        self.uplink_bytes_per_client_round: Optional[int] = None
        self.downlink_bytes_per_client_round: Optional[int] = None
        if stack.protocol:
            if not hasattr(algorithm, "make_protocol_round_fn"):
                raise ValueError(
                    f"algorithm {algorithm.name!r} has no protocol form "
                    "(make_protocol_round_fn); use the staged engine")
            self._round_fn = algorithm.make_protocol_round_fn(grad_fn)
            self._accepts_active = False
        elif stack.split:
            self._set_halves(algorithm, grad_fn,
                             "communication/asynchrony stages")
            self._accepts_active = (
                "active" in inspect.signature(self._server_fn).parameters)
            self.transport = stack.uplink.resolve_transport()
            if stack.downlink is not None:
                self.downlink = stack.downlink.compressor
            if stack.asynchrony is not None:
                self._setup_async()
            # the halves + transport a round uses: the algorithm's own, or
            # (plane mode) wrapped around the flat message plane by
            # _install_plane once the message shape is known
            self._local_eff = self._local_fn
            self._server_eff = self._server_fn
            self._transport_eff = self.transport
        elif stack.placement is not None:
            # a placed round runs the halves, with the uplink between them
            self._set_halves(algorithm, grad_fn, "the placement stage")
            self._accepts_active = (
                "active" in inspect.signature(self._server_fn).parameters)
        else:
            self._round_fn = algorithm.make_round_fn(grad_fn)
            self._accepts_active = (
                "active" in inspect.signature(self._round_fn).parameters)
        if config.participation is not None and not self._accepts_active:
            raise ValueError(
                f"algorithm {algorithm.name!r} does not support partial "
                "participation (round_fn has no 'active' argument)")
        self._use_active = config.participation is not None
        self._plane = bool(config.plane) and stack.split
        self._plane_spec = None  # SegmentSpec of the uplink message plane
        self._extras = None  # the stages' state, built before the 1st round
        self._uplink_sink = None    # per-chunk uplink hand-off (runtime)
        self._uplink_tap = None     # the running chunk's msgs, round by round
        self._snapshot_sink = None  # per-chunk committed-state publication
        self.draws = draws
        if draws is None and stack.split:
            from repro_torch.comm import GeneratorDraws

            self.draws = GeneratorDraws(config.comm_seed, self.device)
        self.clock_draws = clock_draws
        if clock_draws is None and stack.asynchrony is not None:
            from repro_torch.comm import GeneratorDraws

            self.clock_draws = GeneratorDraws(config.clock_seed, self.device)

    def _set_halves(self, algorithm, grad_fn, needs: str) -> None:
        """The algorithm's local and server halves (the local one wrapped
        by :meth:`_placed_local` under placement)."""
        try:
            self._local_fn = algorithm.make_local_fn(grad_fn)
            self._server_fn = algorithm.make_server_fn()
        except NotImplementedError as e:
            raise ValueError(
                f"algorithm {algorithm.name!r} has no local/server split "
                f"(make_local_fn/make_server_fn); run it without {needs}"
            ) from e
        self._round_fn = None
        self._local_raw = self._local_fn
        if self.stack.placement is not None:
            self._local_fn = self._placed_local(self._local_fn)

    def _placed_local(self, local_fn):
        """``local_fn`` on this rank's clients: the client-role fields and
        the batches cut to the rank's rows, the message and aux gathered
        back to every client over the client axes (the uplink)."""
        from torch.distributed.tensor import DTensor

        from repro_torch.launch import sharding as shd

        pl = self.stack.placement
        n = self.n_clients
        sh = pl.client_sharding(n)
        (n_loc,), (lo,) = shd.local_block((n,), sh)
        roles = self.algorithm.state_roles()
        client = [f for f, r in roles.items() if r == "client"]

        def rows(x):
            return x[lo:lo + n_loc]

        def gather(x):
            shape = (n,) + tuple(x.shape[1:])
            spec = shd.PartitionSpec(*(tuple(sh.spec)
                                       + (None,) * (x.ndim - 1)))
            return DTensor.from_local(
                x.contiguous(), pl.mesh, shd.placements(spec, pl.mesh),
                run_check=False, shape=shape,
                stride=shd._contiguous_stride(shape)).full_tensor()

        def local(state, batches):
            if n_loc == n:
                return local_fn(state, batches)
            state = state._replace(**{f: tu.tree_map(rows, getattr(state, f))
                                      for f in client})
            msg, aux = local_fn(state, tu.tree_map(rows, batches))
            return tu.tree_map(gather, msg), tu.tree_map(gather, aux)

        return local

    def _setup_async(self) -> None:
        """Resolve and validate clock, staleness, buffer and queue; the step
        itself is built with the stages' state (plane mode wraps the halves
        around the message shape first)."""
        from repro_torch.sched.aggregator import _validate_buffer

        asyn = self.stack.asynchrony
        self.clock = asyn.resolve_clock()
        self.staleness = asyn.resolve_staleness()
        self.buffer_size = (asyn.buffer_size if asyn.buffer_size is not None
                            else self.n_clients)
        self.edges = asyn.edges if asyn.edges is not None else 1
        # the WORKING width: the buffer and the edge tree partition the
        # participating clients, not the population
        _validate_buffer(self.buffer_size, self.n_clients, self.edges)
        self.queue_depth = asyn.queue_depth
        self._async_round = None

    # -- the stages' state (read-only views) -------------------------------

    @property
    def _comm_state(self):
        return None if self._extras is None else self._extras.get("comm")

    @property
    def _dl_state(self):
        return None if self._extras is None else self._extras.get("dl")

    @property
    def _sched_state(self):
        return None if self._extras is None else self._extras.get("sched")

    def init(self, params0):
        """Algorithm state on the engine's device (working width), placed
        on the mesh under the placement stage."""
        state = self.algorithm.init(to_device(params0, self.device),
                                    self.n_clients)
        if self.stack.placement is not None:
            from repro_torch.launch import sharding as shd

            state = shd.place_tree(state, self.state_shardings(state))
        return state

    def set_state_shardings(self, shardings) -> None:
        """Install precomputed state shardings (placement stage)."""
        self._state_shardings = shardings

    def state_shardings(self, state):
        """Mesh shardings of the federated state (placement stage), from
        the algorithm's :meth:`state_roles` and the plan's rule tables."""
        if self._state_shardings is None:
            self._state_shardings = self.stack.placement.state_shardings(
                self.algorithm, state)
        return self._state_shardings

    def _placed_round(self, state, batches, active):
        """One placed round (see the module docstring): gather, the round on
        the full client axis with the local half on this rank's clients,
        place again."""
        from repro_torch.launch import sharding as shd

        pl = self.stack.placement
        full = shd.gather_tree(state)
        if self.stack.split:
            if self._extras is None:
                self._extras = self._init_extras(full, batches)
            else:
                self._extras = shd.gather_tree(self._extras)
            if self.stack.asynchrony is not None:
                new, info = self._async_step(full, batches)
            else:
                new, info = self._split_round(full, batches, active)
            self._extras = shd.place_tree(
                self._extras, pl.carry_shardings(self._extras,
                                                 self.n_clients))
        else:
            with _trace.span("exec/local", "exec", device=True):
                msg, aux = self._local_fn(full, batches)
            with _trace.span("exec/server", "exec", device=True):
                if active is None:
                    new, info = self._server_fn(full, msg, aux)
                else:
                    new, info = self._server_fn(full, msg, aux,
                                                active=active)
        return shd.place_tree(new, self.state_shardings(new)), info

    def _init_extras(self, state, batches) -> dict:
        """The stages' state from the message's shapes (a shape-only pass
        of the local half on one round's ``batches``): the uplink error
        feedback (one ``(n_clients, d_pad)`` plane in plane mode, after
        :meth:`_install_plane` has wrapped the halves around it), the
        downlink shadow, the async report buffer or queue; and the wire
        bytes, a property of the message, not of the carried layout."""
        msg_t, aux_t = eval_shape(self._local_raw, state, batches)
        self.uplink_bytes_per_client_round = self.transport.uplink_bytes(
            msg_t)
        ex: dict = {}

        def zeros(tree):
            return tu.tree_map(lambda l: torch.zeros(
                tuple(l.shape), dtype=l.dtype, device=self.device), tree)

        buf = self._install_plane(msg_t) if self._plane else zeros(msg_t)
        ex["comm"] = self._transport_eff.init_state(buf)
        if self.downlink is not None:
            fields = server_state_fields(self.algorithm, state)
            self.downlink_bytes_per_client_round = (
                self.downlink.downlink_bytes(fields))
            ex["dl"] = self.downlink.init_state(fields)
        if self.stack.asynchrony is not None:
            from repro_torch.sched import (init_async_state, init_queue_state,
                                           make_async_round)

            if "round" not in aux_t:
                raise ValueError(
                    f"algorithm {self.algorithm.name!r} emits no "
                    "report-round tag (aux['round']); the asynchrony stage "
                    "needs it to age buffered reports")
            start = int(state.round) if hasattr(state, "round") else 0
            if self.queue_depth is not None:
                ex["sched"] = init_queue_state(
                    buf, aux_t, self.n_clients, self.queue_depth,
                    start_round=start, with_resid=self.staleness.correct,
                    device=self.device)
            else:
                ex["sched"] = init_async_state(
                    buf, aux_t, self.n_clients, start_round=start,
                    with_resid=(self.staleness.correct
                                and self.buffer_size < self.n_clients),
                    device=self.device)
            server_fields_fn = None
            if self.downlink is not None:
                server_fields_fn = (
                    lambda st: server_state_fields(self.algorithm, st))
            self._async_round = make_async_round(
                self._local_eff, self._server_eff, self._transport_eff,
                self.clock, self.buffer_size, self.n_clients, self.staleness,
                accepts_active=self._accepts_active,
                queue_depth=self.queue_depth, downlink=self.downlink,
                server_fields_fn=server_fields_fn, edges=self.edges)
        return ex

    def _install_plane(self, msg_template):
        """Build the message plane's spec and wrap the round halves and the
        transport onto the flat layout; returns a zero plane on the device.

        With an ``active`` mask (participation, or the delivered reports of
        an async commit) the server half's weighted client-axis sum is one
        :func:`repro_torch.kernels.ops.plane_weighted_commit` launch over
        the whole plane; the result unflattens to the tree only after it."""
        from repro_torch.comm import PlaneTransport
        from repro_torch.kernels import ops as kops

        spec = pln.SegmentSpec.from_tree(msg_template, batch_dims=1)
        self._plane_spec = spec
        local_fn, server_fn = self._local_fn, self._server_fn
        hook = "weighted_sum" in inspect.signature(server_fn).parameters

        def local_eff(state, batches):
            msg, aux = local_fn(state, batches)
            return pln.flatten(spec, msg), aux

        def server_eff(state, flat, aux, **active):
            tree = pln.unflatten(spec, flat)
            if active.get("active") is None or not hook:
                return server_fn(state, tree, aux, **active)
            return server_fn(
                state, tree, aux, active=active["active"],
                weighted_sum=lambda w: pln.unflatten(
                    spec, kops.plane_weighted_commit(flat, w)))

        self._local_eff = local_eff
        self._server_eff = server_eff
        self._transport_eff = PlaneTransport(self.transport, spec)
        return pln.zeros(spec, self.n_clients, device=self.device)

    def _round(self, state, batches, active):
        with _trace.span("exec/supply", "exec", device=True):
            batches = to_device(batches, self.device)
            if active is not None:
                active = torch.as_tensor(active, device=self.device)
        if self.stack.placement is not None:
            return self._placed_round(state, batches, active)
        if not self.stack.split:
            if active is None:
                return self._round_fn(state, batches)
            return self._round_fn(state, batches, active=active)
        if self._extras is None:
            self._extras = self._init_extras(state, batches)
        if self.stack.asynchrony is not None:
            return self._async_step(state, batches)
        return self._split_round(state, batches, active)

    def _split_round(self, state, batches, active):
        """One round: local half -> uplink compression -> server half ->
        downlink broadcast (``repro/exec/engine.py:674-710``)."""
        ex = self._extras
        if self.downlink is not None:
            # clients compute against the compressed broadcast (what they
            # actually hold); the server state stays authoritative
            state = state._replace(**tu.tree_map(lambda l: l[0],
                                                 ex["dl"]["seen"]))
        with _trace.span("exec/local", "exec", device=True):
            msg, aux = self._local_eff(state, batches)
        cs = ex["comm"]
        with _trace.span("exec/compress", "exec", device=True):
            msg_hat, cs_new = self._transport_eff.compress(cs, msg,
                                                           self.draws)
        if self._uplink_tap is not None:
            self._uplink_tap.append(msg_hat)
        if active is not None:
            # inactive clients transmit nothing, so their error-feedback
            # residuals must not advance (the telescoping identity)
            ex["comm"] = self._transport_eff.select_clients(active, cs_new,
                                                            cs)
            with _trace.span("exec/server", "exec", device=True):
                state, info = self._server_eff(state, msg_hat, aux,
                                               active=active)
        else:
            ex["comm"] = cs_new
            with _trace.span("exec/server", "exec", device=True):
                state, info = self._server_eff(state, msg_hat, aux)
        if self.downlink is not None:
            with _trace.span("exec/broadcast", "exec", device=True):
                _, ex["dl"] = self.downlink.broadcast(
                    ex["dl"], server_state_fields(self.algorithm, state),
                    self.draws)
        return state, info

    def _async_step(self, state, batches):
        """One buffered commit (:func:`repro_torch.sched.make_async_round`)."""
        ex = self._extras
        with _trace.span("exec/async_round", "exec", device=True):
            state, ex["sched"], ex["comm"], dl, info = self._async_round(
                state, ex["sched"], ex["comm"], batches, ex.get("dl"),
                draws=self.draws, clock_draws=self.clock_draws)
        if dl is not None:
            ex["dl"] = dl
        return state, info

    # -- per-chunk sinks -----------------------------------------------------

    def set_uplink_sink(self, sink) -> None:
        """Register a per-chunk uplink hand-off: after each chunk,
        ``sink(start_round, msgs, state)`` receives the chunk's compressed
        uplink messages (``msgs`` stacked ``(chunk, n_clients, ...)`` per
        leaf -- one ``(chunk, n_clients, d_pad)`` buffer in plane mode) and
        the committed post-chunk state, all still on the engine's device.

        This is the engine half of the overlap pipeline in
        :mod:`repro_torch.fed.runtime`: the sink fires once the chunk's
        rounds are enqueued and before the chunk's host sync, so a
        background sender can fetch and serialize chunk k's bytes while
        chunk k+1 computes.  The sink must not mutate its arguments, and
        the engine never writes into them afterwards (the stacked messages
        are a fresh buffer; every round builds a new state).

        The tap rides the split path's straight line only: stages that
        re-route the uplink off it (asynchrony's report buffers, cohort
        residency, partial participation) raise, as in the reference
        (:func:`repro_torch.exec.stages.sink_blockers`).  Pass ``None`` to
        remove the sink.
        """
        if sink is not None:
            if not self.stack.split:
                raise ValueError(
                    "uplink sink needs the split (local/server) engine "
                    "path; a fused or protocol round_fn never materializes "
                    "the uplink message")
            # The port has no jit flag.  Its counterpart of the reference's
            # eager path is the per-round loop that run()'s use_chunk
            # excludes; the engine takes it under participation (a blocker
            # of its own), for the protocol form (no split halves, refused
            # above) and for a supplier without a chunk path -- where the
            # tap runs as on the chunk path (_split_round collects every
            # round), as the reference's compiled per-round path does.  So
            # the eager blocker never fires from here.
            blockers = sink_blockers(self.stack,
                                     participation=self._use_active,
                                     jit=True, kind="uplink")
            if blockers:
                raise ValueError(
                    "uplink sink is unsupported with stage(s): "
                    f"{', '.join(blockers)}; the per-chunk hand-off taps "
                    "the plain split round")
        self._uplink_sink = sink
        self._uplink_tap = None

    def _fire_uplink_sink(self, start_round: int, state) -> None:
        tap, self._uplink_tap = self._uplink_tap, None
        if self._uplink_sink is None or not tap:
            return
        # one fresh (chunk, ...) buffer per leaf, stacked on the device
        msgs = tu.tree_map(lambda *xs: torch.stack(xs), *tap)
        self._uplink_sink(start_round, msgs, state)

    def set_snapshot_sink(self, sink) -> None:
        """Register a per-chunk serving-snapshot publication hook: after
        each committed chunk, ``sink(end_round, state)`` receives the round
        index just completed and the committed post-chunk state, still on
        the engine's device, before the chunk's host sync.
        :meth:`repro_torch.serving.SnapshotStore.engine_sink` builds the
        standard sink.

        It only reads state the engine holds at every chunk boundary, so it
        composes with every stage combination except the protocol form.
        The sink must not mutate ``state``.  Pass ``None`` to remove.
        """
        if sink is not None:
            blockers = sink_blockers(self.stack,
                                     participation=self._use_active,
                                     jit=True, kind="snapshot")
            if blockers:
                raise ValueError(
                    "snapshot sink is unsupported with stage(s): "
                    f"{', '.join(blockers)}; the protocol form bypasses "
                    "the engine's chunk structure")
        self._snapshot_sink = sink

    def _fire_snapshot_sink(self, end_round: int, state) -> None:
        if self._snapshot_sink is None:
            return
        with _trace.span("exec/snapshot_publish", "exec",
                         end_round=int(end_round)):
            self._snapshot_sink(end_round, state)

    # -- cohort residency (stack.cohort; see repro_torch.sched.cohort) ------

    @property
    def population_store(self):
        """The host-resident population store (``None`` without the cohort
        stage); current as of the last chunk boundary -- call
        :meth:`flush_cohort` first after ``step`` loops."""
        return None if self._cohort is None else self._cohort.store

    @property
    def cohort_ids(self):
        """Global client ids of the resident working set (``None`` without
        the cohort stage); before the first chunk, the cohort the next
        :meth:`step` will materialize."""
        if self._cohort is None:
            return None
        if self._cohort.current_ids is None:
            return self._cohort.spec.sample(self._cohort_round)
        return self._cohort.current_ids

    def _cohort_entries(self, state) -> dict:
        """``name -> (tree, client_axes)`` of every per-client slice the
        resident cohort swaps: the algorithm's client-role fields, the
        uplink error feedback, the per-client fields of the async buffer."""
        try:
            roles = self.algorithm.state_roles()
        except NotImplementedError as e:
            raise ValueError(
                f"algorithm {self.algorithm.name!r} declares no state "
                "roles; cohort-resident state needs state_roles() to know "
                "which fields carry the client axis") from e
        entries: dict = {}
        client = {f: getattr(state, f)
                  for f, r in roles.items() if r == "client"}
        if client:
            entries["alg"] = (client, {f: 0 for f in client})
        if self._extras is not None:
            comm = self._extras.get("comm")
            if comm is not None and tu.tree_leaves(comm):
                entries["comm"] = (comm, 0)
            sched = self._extras.get("sched")
            if sched is not None:
                from repro_torch.sched.cohort import sched_client_axes

                axes = sched_client_axes(sched)
                fields = {f: getattr(sched, f)
                          for f, a in axes.items() if a is not None}
                entries["sched"] = (fields, {f: axes[f] for f in fields})
        return entries

    def _cohort_swap(self, state, chunk_start: int):
        """Scatter the current working set home under its global ids and
        gather the cohort of the chunk starting at ``chunk_start``.  The
        first call registers the entries from the initial working set (its
        rows ARE the store's default rows)."""
        rc = self._cohort
        ids = rc.sample(chunk_start)
        entries = self._cohort_entries(state)
        if rc.current_ids is None:
            for name, (tree, axes) in entries.items():
                rc.register(name, tree, axes)
            rc.current_ids = ids
            return state
        for name, (tree, _axes) in entries.items():
            rc.scatter(name, rc.current_ids, tree)
        rc.current_ids = ids
        gathered = {name: rc.gather(name, ids) for name in entries}
        if "alg" in gathered:
            state = state._replace(**gathered["alg"])
        if "comm" in gathered:
            self._extras["comm"] = gathered["comm"]
        if "sched" in gathered:
            self._extras["sched"] = self._extras["sched"]._replace(
                **gathered["sched"])
        return state

    def flush_cohort(self, state) -> None:
        """Scatter the resident working set home to the population store;
        :meth:`run` does this before returning."""
        rc = self._cohort
        if rc is None or rc.current_ids is None:
            return
        for name, (tree, _axes) in self._cohort_entries(state).items():
            rc.scatter(name, rc.current_ids, tree)

    def _cohort_batches(self, supplier, r0: int, c: int, rng,
                        use_chunk: bool) -> list:
        """One chunk's per-round batches for the cohort of round ``r0``."""
        rc = self._cohort
        kw = {}
        if not rc.spec.is_full:
            # the full cohort keeps the suppliers' plain call shape (bitwise
            # the dense engine); a strict sub-cohort needs per-id draws
            if not supports_client_ids(supplier):
                raise ValueError(
                    f"supplier {type(supplier).__name__} does not accept "
                    "client_ids: a strict sub-cohort (cohort < population) "
                    "needs per-id batch draws -- accept a client_ids "
                    "keyword (an int64 array of global ids) in "
                    "sample_round/sample_chunk, or use "
                    "repro_torch.exec.ArraySupplier")
            kw["client_ids"] = rc.sample(r0)
        if use_chunk:
            chunk = supplier.sample_chunk(r0, c, rng, **kw)
            return [tu.tree_map(lambda x, i=i: x[i], chunk)
                    for i in range(c)]
        return [supplier.sample_round(r0 + i, rng, **kw) for i in range(c)]

    # -- public API ---------------------------------------------------------

    def run(self, state, batch_supplier, rounds: int, *,
            rng: Optional[np.random.Generator] = None, seed: int = 0,
            start_round: int = 0,
            metrics_cb: Optional[Callable[[int, dict], None]] = None):
        """Run ``rounds`` rounds from ``state``; returns (state, metrics).

        ``metrics`` maps metric name -> list with one entry per executed
        round (a float, or an array for vector metrics).
        ``metrics_cb(round_idx, round_metrics)``, if given, fires per round
        after each chunk's host sync.  Chunk-aware
        suppliers serve whole chunks through ``sample_chunk``; under partial
        participation, or for a plain callable, batches are drawn per round,
        each followed by that round's mask draw.  Under the cohort stage
        each chunk first swaps the working set to the chunk's cohort.
        """
        if rng is None:
            rng = np.random.default_rng(seed)
        supplier = as_supplier(batch_supplier)
        use_chunk = (has_chunk_path(supplier) and not self._use_active
                     and not self.stack.protocol)
        metrics: dict[str, list] = {}
        done = 0
        tracer = _trace.get()
        while done < rounds:
            c = min(self.config.chunk_rounds, rounds - done)
            r0 = start_round + done
            infos = []
            with tracer.span("exec/chunk", "exec", start_round=r0,
                             rounds=c) as chunk_span:
                counts = tracer.counters()
                if self._cohort is not None:
                    with tracer.span("exec/supply", "exec", device=True):
                        per_round = self._cohort_batches(supplier, r0, c,
                                                         rng, use_chunk)
                    if self.stack.split and self._extras is None:
                        # the stages' state must exist before the first
                        # swap registers it (its init rows are the default
                        # rows)
                        self._extras = self._init_extras(
                            state, to_device(per_round[0], self.device))
                    state = self._cohort_swap(state, r0)
                    for b in per_round:
                        state, info = self._round(state, b, None)
                        infos.append(info)
                else:
                    if self._uplink_sink is not None:
                        self._uplink_tap = []
                    if use_chunk:
                        with tracer.span("exec/supply", "exec", device=True):
                            chunk = supplier.sample_chunk(r0, c, rng)
                        for i in range(c):
                            state, info = self._round(
                                state, tu.tree_map(lambda x: x[i], chunk),
                                None)
                            infos.append(info)
                    else:
                        for i in range(c):
                            with tracer.span("exec/supply", "exec",
                                             device=True):
                                batches = supplier.sample_round(r0 + i, rng)
                                active = (sample_active_masks(
                                    self.n_clients, 1,
                                    self.config.participation, rng)[0]
                                    if self._use_active else None)
                            state, info = self._round(state, batches, active)
                            infos.append(info)
                    # hand the chunk's uplink to the sink BEFORE the host
                    # sync: an overlapping sender fetches chunk k's bytes
                    # while this thread enqueues chunk k+1
                    self._fire_uplink_sink(r0, state)
                self._fire_snapshot_sink(r0 + c, state)
                # the chunk's ONE host sync: every round's metrics in one copy
                with tracer.span("exec/host_sync", "exec"):
                    rows = _host_metrics(infos)
                if counts is not None:
                    chunk_span.set(**_trace.counter_deltas(
                        counts, tracer.counters()))
            # the device has drained: its spans' intervals go on the clock
            tracer.settle()
            for i, row in enumerate(rows):
                for k, v in row.items():
                    metrics.setdefault(k, []).append(v)
                if metrics_cb is not None:
                    metrics_cb(r0 + i, row)
            done += c
        if self._cohort is not None:
            self._cohort_round = start_round + rounds
            self.flush_cohort(state)
        return state, metrics

    def step(self, state, batches, active=None):
        """One round (the ``round_fn(state, batches)`` surface).  Under the
        cohort stage it runs on the current working set (the first call
        materializes the announced :attr:`cohort_ids`)."""
        if active is not None and not self._accepts_active:
            raise ValueError("this algorithm's round_fn takes no active mask")
        if self._use_active and active is None:
            raise ValueError("engine configured with participation; pass the "
                             "active mask explicitly to step()")
        if self._cohort is not None and self._cohort.current_ids is None:
            if self.stack.split and self._extras is None:
                self._extras = self._init_extras(
                    state, to_device(batches, self.device))
            state = self._cohort_swap(state, self._cohort_round)
        state, info = self._round(state, batches, active)
        return state, _host_metrics([info])[0]

    def global_params(self, state):
        """The deployable global model, gathered to full tensors under the
        placement stage."""
        if self.stack.placement is not None:
            from repro_torch.launch import sharding as shd

            state = shd.gather_tree(state)
        return self.algorithm.global_params(state)
