"""The round-execution engine.

The counterpart of :class:`repro.exec.RoundEngine` with its communication
stages (uplink and downlink compression, :mod:`repro_torch.exec.stages`);
placement, asynchrony and cohorts are not ported yet.  It runs one
(algorithm, grad_fn, n_clients) triple round after round.

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
the round is *split*, as the reference's compiled scan body
(``repro/exec/engine.py:674-710``): the local half, then
``transport.compress`` of the uplink message, then (under participation)
``select_clients`` on the error feedback, then the server half, then
``downlink.broadcast`` of the new server state.  Clients compute against the
downlink shadow; the server state stays authoritative.  ``plane=True``
carries the message and its error feedback as one ``(n_clients, d_pad)``
plane.  The stages' state (``comm``: error feedback, ``dl``: the shadow)
lives on the engine and persists across ``run``/``step`` calls; it is built
from the first round's real message (the reference traces it with
``jax.eval_shape``; the port takes it from that first call).

Draws: the reference splits a ``jax.random`` key each round; the port's
stochastic compressors consume ONE draw source (``draws=``, by default a
``torch.Generator`` on the engine's device seeded with ``comm_seed``) in a
fixed order: per round, the uplink's draws (leaves in ``jax.tree_util``
order, rows in order), then the downlink's.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import plane as pln
from repro_torch.device import resolve_device, to_device
from repro_torch.exec.stages import DownlinkComm, StageStack, UplinkComm
from repro_torch.exec.suppliers import as_supplier, has_chunk_path
from repro_torch.utils import tree as tu

# stage fields of the reference's EngineConfig that the port does not run
# yet, and the slice of ROADMAP Queue 1 that brings each
_ASYNC = "asynchrony stage (Queue 1 item 12, the async + cohort slice)"
_LATER_STAGES = {
    "mesh": "placement stage (Queue 1 item 15, launch/mesh + sharding)",
    "clock": _ASYNC, "buffer_size": _ASYNC, "staleness": _ASYNC,
    "queue_depth": _ASYNC, "edges": _ASYNC,
    "population": "cohort stage (Queue 1 item 12, the async + cohort slice)",
    "cohort": "cohort stage (Queue 1 item 12, the async + cohort slice)",
}


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
                     Requires a round function with an ``active`` argument.
    plane          : carry the uplink message and its error feedback as ONE
                     flat ``(n_clients, d_pad)`` plane
                     (:mod:`repro_torch.core.plane`) between the round's
                     halves.  A no-op without a communication stage;
                     requires a single-dtype message.

    UplinkComm stage (active when ``transport`` is set, or implicitly under
    ``downlink``, defaulting to Dense):
    transport      : the uplink compressor (:mod:`repro_torch.comm`).
    comm_seed      : seed of the default draw source (rand-k and stochastic
                     quantization draws).

    DownlinkComm stage (active when ``downlink`` is set):
    downlink       : a :class:`repro_torch.comm.DownlinkCompressor` (or a
                     plain Transport, which gets wrapped) compressing the
                     broadcast server-state innovation.

    The reference's placement, asynchrony and cohort fields (``mesh``,
    ``clock``, ``buffer_size``, ``staleness``, ``queue_depth``, ``edges``,
    ``population``, ``cohort``) must stay ``None``: setting one raises and
    names the slice that ports it.
    """

    chunk_rounds: int = 1
    participation: Optional[float] = None
    plane: bool = False
    transport: Any = None
    comm_seed: int = 0
    downlink: Any = None
    mesh: Any = None
    clock: Any = None
    buffer_size: Optional[int] = None
    staleness: Any = None
    queue_depth: Optional[int] = None
    edges: Optional[int] = None
    population: Optional[int] = None
    cohort: Optional[int] = None

    def resolve(self) -> StageStack:
        """Validate and map this config onto its :class:`StageStack`."""
        if self.chunk_rounds < 1:
            raise ValueError(
                f"chunk_rounds must be >= 1, got {self.chunk_rounds}")
        if self.participation is not None and not (
                0.0 < self.participation <= 1.0):
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")
        for field, later in _LATER_STAGES.items():
            if getattr(self, field) is not None:
                raise NotImplementedError(
                    f"EngineConfig({field}=...) is not ported yet: it comes "
                    f"with the {later}")
        if self.transport is not None and not hasattr(self.transport,
                                                      "compress"):
            raise ValueError(
                "transport must implement the repro_torch.comm.Transport "
                f"interface, got {type(self.transport).__name__}")
        downlink_on = self.downlink is not None
        return StageStack(
            uplink=(UplinkComm(self.transport)
                    if self.transport is not None or downlink_on else None),
            downlink=(DownlinkComm.coerce(self.downlink)
                      if downlink_on else None))

    def validate(self) -> None:
        self.resolve()


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


class RoundEngine:
    """Runs federated rounds for one (algorithm, grad_fn, n_clients) triple
    on one device (``cuda`` unless ``device`` says otherwise).

    ``draws`` is the draw source of the stochastic compressors (see the
    module docstring); by default a ``torch.Generator`` on the engine's
    device seeded with ``config.comm_seed``.
    """

    def __init__(self, algorithm, grad_fn, n_clients: int,
                 config: EngineConfig = EngineConfig(), *, device=None,
                 draws=None):
        stack = config.resolve()
        self.algorithm = algorithm
        self.grad_fn = grad_fn
        self.n_clients = n_clients
        self.config = config
        self.stack = stack
        self.device = resolve_device(device)
        self.transport = None
        self.downlink = None
        # per-client wire bytes of one uplink message / one broadcast, known
        # once the first round has produced a message
        self.uplink_bytes_per_client_round: Optional[int] = None
        self.downlink_bytes_per_client_round: Optional[int] = None
        if stack.split:
            try:
                self._local_fn = algorithm.make_local_fn(grad_fn)
                self._server_fn = algorithm.make_server_fn()
            except NotImplementedError as e:
                raise ValueError(
                    f"algorithm {algorithm.name!r} has no local/server split "
                    "(make_local_fn/make_server_fn); run it without "
                    "communication stages") from e
            self._round_fn = None
            self._accepts_active = (
                "active" in inspect.signature(self._server_fn).parameters)
            self.transport = stack.uplink.resolve_transport()
            if stack.downlink is not None:
                self.downlink = stack.downlink.compressor
            # the halves + transport a round uses: the algorithm's own, or
            # (plane mode) wrapped around the flat message plane by
            # _install_plane once the message shape is known
            self._local_eff = self._local_fn
            self._server_eff = self._server_fn
            self._transport_eff = self.transport
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
        self._extras = None  # the stages' state, built at the first round
        self.draws = draws
        if draws is None and stack.split:
            from repro_torch.comm import GeneratorDraws

            self.draws = GeneratorDraws(config.comm_seed, self.device)

    # -- the stages' state (read-only views) -------------------------------

    @property
    def _comm_state(self):
        return None if self._extras is None else self._extras.get("comm")

    @property
    def _dl_state(self):
        return None if self._extras is None else self._extras.get("dl")

    def init(self, params0):
        """Algorithm state on the engine's device."""
        return self.algorithm.init(to_device(params0, self.device),
                                   self.n_clients)

    def _round(self, state, batches, active):
        batches = to_device(batches, self.device)
        if active is not None:
            active = torch.as_tensor(active, device=self.device)
        if self.stack.split:
            return self._split_round(state, batches, active)
        if active is None:
            return self._round_fn(state, batches)
        return self._round_fn(state, batches, active=active)

    def _split_round(self, state, batches, active):
        """One round: local half -> uplink compression -> server half ->
        downlink broadcast (``repro/exec/engine.py:674-710``)."""
        if self._extras is None:
            self._extras = self._init_downlink(state)
        ex = self._extras
        if self.downlink is not None:
            # clients compute against the compressed broadcast (what they
            # actually hold); the server state stays authoritative
            state = state._replace(**tu.tree_map(lambda l: l[0],
                                                 ex["dl"]["seen"]))
        msg, aux = self._local_eff(state, batches)
        if "comm" not in ex:
            msg = self._init_extras(msg)
        cs = ex["comm"]
        msg_hat, cs_new = self._transport_eff.compress(cs, msg, self.draws)
        if active is not None:
            # inactive clients transmit nothing, so their error-feedback
            # residuals must not advance (the telescoping identity)
            ex["comm"] = self._transport_eff.select_clients(active, cs_new,
                                                            cs)
            state, info = self._server_eff(state, msg_hat, aux,
                                           active=active)
        else:
            ex["comm"] = cs_new
            state, info = self._server_eff(state, msg_hat, aux)
        if self.downlink is not None:
            _, ex["dl"] = self.downlink.broadcast(
                ex["dl"], server_state_fields(self.algorithm, state),
                self.draws)
        return state, info

    def _init_downlink(self, state) -> dict:
        """The downlink shadow, from the initial server state."""
        if self.downlink is None:
            return {}
        fields = server_state_fields(self.algorithm, state)
        self.downlink_bytes_per_client_round = (
            self.downlink.downlink_bytes(fields))
        return {"dl": self.downlink.init_state(fields)}

    def _init_extras(self, msg):
        """The uplink's state from the first real message (the reference
        builds it from ``jax.eval_shape`` of the local half): the error
        feedback, shaped like the message -- or, in plane mode, one
        ``(n_clients, d_pad)`` plane, once :meth:`_install_plane` has wrapped
        the round's halves around it -- and the wire bytes, a property of
        the message, not of the carried layout.  Returns the first message
        in the carried layout."""
        self.uplink_bytes_per_client_round = self.transport.uplink_bytes(msg)
        if self._plane:
            flat = self._install_plane(msg)
            self._extras["comm"] = self._transport_eff.init_state(flat)
            return flat
        self._extras["comm"] = self._transport_eff.init_state(msg)
        return msg

    def _install_plane(self, msg):
        """Build the message plane's spec and wrap the round halves and the
        transport onto the flat layout; returns ``msg`` as a plane."""
        from repro_torch.comm import PlaneTransport

        spec = pln.SegmentSpec.from_tree(msg, batch_dims=1)
        self._plane_spec = spec
        local_fn, server_fn = self._local_fn, self._server_fn

        def local_eff(state, batches):
            msg, aux = local_fn(state, batches)
            return pln.flatten(spec, msg), aux

        def server_eff(state, flat, aux, **active):
            return server_fn(state, pln.unflatten(spec, flat), aux, **active)

        self._local_eff = local_eff
        self._server_eff = server_eff
        self._transport_eff = PlaneTransport(self.transport, spec)
        return pln.flatten(spec, msg)

    def run(self, state, batch_supplier, rounds: int, *,
            rng: Optional[np.random.Generator] = None, seed: int = 0,
            start_round: int = 0):
        """Run ``rounds`` rounds from ``state``; returns (state, metrics).

        ``metrics`` maps metric name -> list with one float per executed
        round.  Chunk-aware suppliers serve whole chunks through
        ``sample_chunk``; under partial participation, or for a plain
        callable, batches are drawn per round, each followed by that round's
        mask draw.
        """
        if rng is None:
            rng = np.random.default_rng(seed)
        supplier = as_supplier(batch_supplier)
        use_chunk = has_chunk_path(supplier) and not self._use_active
        metrics: dict[str, list] = {}
        done = 0
        while done < rounds:
            c = min(self.config.chunk_rounds, rounds - done)
            r0 = start_round + done
            infos = []
            if use_chunk:
                chunk = supplier.sample_chunk(r0, c, rng)
                for i in range(c):
                    state, info = self._round(
                        state, tu.tree_map(lambda x: x[i], chunk), None)
                    infos.append(info)
            else:
                for i in range(c):
                    batches = supplier.sample_round(r0 + i, rng)
                    active = (sample_active_masks(
                        self.n_clients, 1, self.config.participation, rng)[0]
                        if self._use_active else None)
                    state, info = self._round(state, batches, active)
                    infos.append(info)
            # the chunk's ONE host sync: every round's metrics in one copy
            keys = list(infos[0])
            if keys:
                vals = torch.stack([torch.stack([info[k].float() for k in keys])
                                    for info in infos]).cpu().numpy()
                for j, k in enumerate(keys):
                    metrics.setdefault(k, []).extend(
                        float(v) for v in vals[:, j])
            done += c
        return state, metrics

    def step(self, state, batches, active=None):
        """One round (the ``round_fn(state, batches)`` surface)."""
        if active is not None and not self._accepts_active:
            raise ValueError("this algorithm's round_fn takes no active mask")
        if self._use_active and active is None:
            raise ValueError("engine configured with participation; pass the "
                             "active mask explicitly to step()")
        state, info = self._round(state, batches, active)
        return state, {k: float(v) for k, v in info.items()}

    def global_params(self, state):
        return self.algorithm.global_params(state)
