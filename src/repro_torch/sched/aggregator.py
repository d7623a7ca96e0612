"""Buffered, staleness-aware server aggregation over virtual-time clients.

The counterpart of :mod:`repro.sched.aggregator`: a FedBuff-style buffered
aggregator over a fixed-size in-flight report buffer.  One call of the step
is one server *commit*:

  1. **Refresh** -- every client flagged ``need_refresh`` (it delivered at
     the previous commit) computes its next report from the current global
     state, pushes it through the uplink transport (advancing only that
     client's error feedback), and schedules its arrival at ``vtime +
     duration``.  Clients still "computing" keep their pending report,
     anchored to the round it was computed at: that is what makes it stale.
  2. **Commit** -- the server takes the ``buffer_size`` earliest arrivals
     (a stable sort of the delivery times: ties go to the lower client id,
     as ``lax.top_k`` breaks them), advances the virtual clock to the
     ``buffer_size``-th arrival and aggregates only the delivered reports,
     staleness-weighted by scaling the messages, through the server half's
     ``active`` mask when it has one.
  3. **Stale-innovation correction** (``Staleness(correct=True)``) -- the
     un-applied ``(1 - w)`` fraction of each delivered report stays in a
     per-client residual and returns at that client's next delivery, so
     ``sum(applied) = sum(produced) - e_T`` exactly.

Zero-delay contract: with a :class:`~repro_torch.sched.clock.DeterministicClock`
and ``buffer_size == n_clients`` every step refreshes and delivers every
client, every age is zero, and the step is ``server_fn(state,
local_fn(state, batch))`` with no select and no scale in between -- bitwise
the port's synchronous round.

The reference threads ``jax.random`` keys through its scan carry; the port
takes two draw sources per step instead: ``draws`` (the transports', as the
synchronous engine) and ``clock_draws`` (the clock's).  The states are
``NamedTuple``\\ s of tensors without the reference's ``clock_key`` field.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.sched.clock import clock_is_stochastic, split_durations
from repro_torch.utils import tree as tu

AGE_HIST_BUCKETS = 8  # report-age histogram buckets (last bucket = overflow)

STALENESS_WEIGHTINGS = ("uniform", "poly")


@dataclass(frozen=True)
class Staleness:
    """Staleness handling policy for buffered aggregation.

    weighting : "uniform" keeps every delivered report at weight 1; "poly"
                downweights age-``a`` reports by ``(1 + a) ** -alpha``.
                Without correction the weights are normalized inside the
                aggregator.
    alpha     : the polynomial decay exponent.
    correct   : error feedback on the downweighting (see the module
                docstring); a no-op under uniform weights.
    """

    weighting: str = "uniform"
    alpha: float = 0.5
    correct: bool = False

    def validate(self) -> None:
        if self.weighting not in STALENESS_WEIGHTINGS:
            raise ValueError(
                f"staleness weighting must be one of {STALENESS_WEIGHTINGS}, "
                f"got {self.weighting!r}")
        if self.alpha < 0:
            raise ValueError(f"staleness alpha must be >= 0, got {self.alpha}")

    def weights(self, age: torch.Tensor) -> torch.Tensor:
        """Per-report mixing weight from the report age (rounds), in
        float64: the reference's default float type under x64, so the
        weighting and the correction's residual split do not round below
        the message precision."""
        f64 = torch.float64
        if self.weighting == "uniform":
            return torch.ones(tuple(age.shape), dtype=f64, device=age.device)
        return (1.0 + age.to(f64)) ** torch.tensor(-self.alpha, dtype=f64,
                                                   device=age.device)


def as_staleness(policy) -> Staleness:
    """Coerce None / "poly" / Staleness to a validated policy."""
    if policy is None:
        policy = Staleness()
    elif isinstance(policy, str):
        policy = Staleness(weighting=policy)
    if not isinstance(policy, Staleness):
        raise ValueError(
            f"staleness must be None, a weighting name or a "
            f"repro_torch.sched.Staleness, got {type(policy).__name__}")
    policy.validate()
    return policy


class AsyncState(NamedTuple):
    """The one-slot in-flight report buffer + staleness ledger.

    ``pending_msg``/``pending_aux`` hold each client's computed but not yet
    delivered report (the birth round rides in ``pending_aux["round"]``);
    ``resid`` is the per-client residual of the stale-innovation correction
    (message-shaped; ``()`` when correction is off).  In plane mode the
    message buffers are ``(n_clients, d_pad)`` planes.
    """

    pending_msg: Any
    pending_aux: Any
    resid: Any
    deliver_time: torch.Tensor  # (n_clients,) f32 virtual arrival times
    need_refresh: torch.Tensor  # (n_clients,) bool -- re-synced last commit
    last_synced: torch.Tensor   # (n_clients,) i32 ledger (-1 = never)
    last_age: torch.Tensor      # (n_clients,) i32 age of each client's most
    #                             recent delivery (0 = never / fresh)
    vtime: torch.Tensor         # scalar f32 virtual wall-clock
    round_idx: torch.Tensor     # scalar i32 server commit counter


class QueueState(NamedTuple):
    """The multi-slot in-flight report queue + staleness ledger: up to
    ``queue_depth`` computed but undelivered reports per client, uploaded
    FIFO; the server consumes each client's queue head.  Message and aux
    buffers carry a leading ``(queue_depth, n_clients)`` pair of axes (a
    ``(depth, n_clients, d_pad)`` plane in plane mode); empty slots hold
    ``+inf`` delivery times."""

    pending_msg: Any
    pending_aux: Any
    resid: Any
    slot_filled: torch.Tensor   # (queue_depth, n_clients) bool
    deliver_time: torch.Tensor  # (queue_depth, n_clients) f32 (+inf = empty)
    last_synced: torch.Tensor   # (n_clients,) i32 ledger (-1 = never)
    last_age: torch.Tensor      # (n_clients,) i32
    vtime: torch.Tensor         # scalar f32 virtual wall-clock
    round_idx: torch.Tensor     # scalar i32 server commit counter


def _check_client_axis(msg_spec, aux_spec, n_clients: int) -> None:
    for name, spec in (("msg", msg_spec), ("aux", aux_spec)):
        for leaf in tu.tree_leaves(spec):
            if len(leaf.shape) < 1 or leaf.shape[0] != n_clients:
                raise ValueError(
                    f"the asynchrony stage requires every {name} leaf to "
                    f"carry a leading client axis of size {n_clients}; got "
                    f"shape {tuple(leaf.shape)} (per-client reports cannot "
                    "be buffered otherwise)")


def _zeros(spec, device, lead=()):
    return tu.tree_map(
        lambda l: torch.zeros(lead + tuple(l.shape), dtype=l.dtype,
                              device=device), spec)


def _ledger_fields(n_clients: int, start_round: int, device) -> dict:
    return dict(
        last_synced=torch.full((n_clients,), -1, dtype=torch.int32,
                               device=device),
        last_age=torch.zeros((n_clients,), dtype=torch.int32, device=device),
        vtime=torch.zeros((), dtype=torch.float32, device=device),
        round_idx=torch.full((), start_round, dtype=torch.int32,
                             device=device))


def init_async_state(msg_spec, aux_spec, n_clients: int, start_round: int = 0,
                     with_resid: bool = False, device="cpu") -> AsyncState:
    """Zero-filled buffer with every client flagged for refresh, so the
    first step overwrites every slot before anything is delivered.
    ``msg_spec``/``aux_spec`` are tensors of the report's shapes and dtypes
    (any device; ``meta`` costs nothing); the state lives on ``device``.
    ``start_round`` aligns the commit counter with the algorithm state's
    round counter (report ages subtract the two)."""
    _check_client_axis(msg_spec, aux_spec, n_clients)
    return AsyncState(
        pending_msg=_zeros(msg_spec, device),
        pending_aux=_zeros(aux_spec, device),
        resid=_zeros(msg_spec, device) if with_resid else (),
        deliver_time=torch.zeros((n_clients,), dtype=torch.float32,
                                 device=device),
        need_refresh=torch.ones((n_clients,), dtype=torch.bool,
                                device=device),
        **_ledger_fields(n_clients, start_round, device))


def init_queue_state(msg_spec, aux_spec, n_clients: int, queue_depth: int,
                     start_round: int = 0, with_resid: bool = False,
                     device="cpu") -> QueueState:
    """Empty ``queue_depth``-deep report queue: every slot free, so the
    first step enqueues one fresh report per client."""
    if queue_depth < 1:
        raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
    _check_client_axis(msg_spec, aux_spec, n_clients)
    return QueueState(
        pending_msg=_zeros(msg_spec, device, (queue_depth,)),
        pending_aux=_zeros(aux_spec, device, (queue_depth,)),
        resid=_zeros(msg_spec, device) if with_resid else (),
        slot_filled=torch.zeros((queue_depth, n_clients), dtype=torch.bool,
                                device=device),
        deliver_time=torch.full((queue_depth, n_clients), float("inf"),
                                dtype=torch.float32, device=device),
        **_ledger_fields(n_clients, start_round, device))


def _where_clients(mask, new, old):
    """Per-client select across a pytree (leaves have leading client axis)."""
    return tu.tree_map(
        lambda n, o: torch.where(
            mask.reshape((-1,) + (1,) * (n.ndim - 1)), n, o), new, old)


def _earliest_k(deliver_time, k: int, edges: int = 1):
    """Indices + threshold time of the ``k`` earliest arrivals.

    A stable ascending sort puts equal delivery times in client-id order,
    which is how ``lax.top_k`` on the negated times breaks ties in the
    reference (``torch.topk`` promises no order among ties, and the
    deterministic clock makes ties the rule).  ``edges > 1`` runs the
    client->edge->root tournament: each edge keeps its ``min(k, n/edges)``
    earliest, the root the global ``k`` among those candidates (ties then
    break edge-major, as in the reference).
    """
    if edges <= 1:
        t, idx = torch.sort(deliver_time, stable=True)
        return idx[:k], t[k - 1]
    n = deliver_time.shape[0]
    per = n // edges
    ke = min(k, per)
    t_e, loc = torch.sort(deliver_time.reshape(edges, per), dim=1,
                          stable=True)
    t_e, loc = t_e[:, :ke], loc[:, :ke]
    gidx = loc + (torch.arange(edges, device=loc.device) * per)[:, None]
    t_r, pos = torch.sort(t_e.reshape(-1), stable=True)
    return gidx.reshape(-1)[pos[:k]], t_r[k - 1]


def _edge_sum(x, edges: int = 1):
    """Client-axis sum reduced client->edge->root (per-edge partial sums
    first when ``edges > 1``)."""
    if edges <= 1:
        return torch.sum(x, dim=0)
    return torch.sum(torch.sum(x.reshape((edges, -1) + tuple(x.shape[1:])),
                               dim=1), dim=0)


def _validate_buffer(buffer_size: int, n_clients: int, edges: int) -> None:
    """Geometry checks shared by the engine config and
    :func:`make_async_round`."""
    if not 1 <= buffer_size <= n_clients:
        raise ValueError(
            f"buffer_size must be in [1, n_clients={n_clients}], got "
            f"{buffer_size}: the commit waits for the buffer_size earliest "
            "arrivals, so a buffer wider than the participating clients can "
            "never fill")
    if edges < 1:
        raise ValueError(f"edges must be >= 1, got {edges}")
    if n_clients % edges:
        raise ValueError(
            f"edges={edges} must divide n_clients={n_clients}: the "
            "client->edge->root aggregation tree partitions the client axis "
            "into equal edge groups (pick an edge count that divides the "
            "cohort width)")


def _scale_msg(msg, scale):
    return tu.tree_map(
        lambda m: m * scale.reshape((-1,) + (1,) * (m.ndim - 1)).to(m.dtype),
        msg)


def _delivered_mask(idx, n_clients: int, device):
    mask = torch.zeros((n_clients,), dtype=torch.bool, device=device)
    mask[idx] = True
    return mask


def make_async_round(local_fn, server_fn, transport, clock, buffer_size: int,
                     n_clients: int, staleness: Staleness,
                     accepts_active: bool = False,
                     queue_depth: Optional[int] = None, downlink=None,
                     server_fields_fn=None, edges: int = 1):
    """Build the async step the engine calls once per commit:

        step(state, sched, comm_state, batch, dl_state=None, *, draws=None,
             clock_draws=None) -> (state, sched, comm_state, dl_state, info)

    ``queue_depth=None`` runs the one-slot :class:`AsyncState`; a depth runs
    the :class:`QueueState` queue (depth 1 is the one-slot trajectory).
    ``edges`` partitions the client axis into a client->edge->root tree for
    the arrival selection and the commit normalization.  ``downlink`` (a
    :class:`repro_torch.comm.DownlinkCompressor`) makes clients compute
    against the compressed shadow (``server_fields_fn(state)`` names the
    broadcast fields) and re-broadcasts after every commit.  Draws are
    consumed in the synchronous engine's order: the uplink's, then the
    downlink's; the clock takes its own source.
    """
    if downlink is not None and server_fields_fn is None:
        raise ValueError(
            "downlink compression under asynchrony needs server_fields_fn "
            "(state -> broadcast field dict) to rebuild the client-visible "
            "state from the shadow")
    _validate_buffer(buffer_size, n_clients, edges)
    full_buffer = buffer_size == n_clients
    # staleness-adaptive transport (repro_torch.comm.schedule): compression
    # takes the per-client last_age ledger, and the realized per-commit wire
    # bytes ride the info dict
    tr_scheduled = getattr(transport, "scheduled", False)
    clk_stochastic = clock_is_stochastic(clock)

    def visible(state, dl_state):
        """The state clients actually hold: server fields replaced by the
        downlink shadow."""
        if downlink is None:
            return state
        return state._replace(**tu.tree_map(lambda l: l[0], dl_state["seen"]))

    def durations(sched, clock_draws, device):
        comp, upl = split_durations(
            clock, clock_draws if clk_stochastic else None, sched.round_idx,
            n_clients, device)
        return comp.to(torch.float32), upl.to(torch.float32)

    def commit(state, msg, aux, resid, delivered, age):
        """Staleness-weighted buffered aggregation of the delivered reports
        (shared by the one-slot and queued paths)."""
        zero = torch.zeros((), dtype=torch.float64, device=age.device)
        w = torch.where(delivered, staleness.weights(age), zero)
        if staleness.correct:
            target = tu.tree_map(torch.add, msg, resid)
            resid = _where_clients(delivered, _scale_msg(target, 1.0 - w),
                                   resid)
            msg_in, wn = target, w
        else:
            msg_in = msg
            k = torch.tensor(float(buffer_size), dtype=torch.float64,
                             device=w.device)
            wn = w * (k / torch.clamp_min(_edge_sum(w, edges), 1e-30))
        if accepts_active:
            # the server's active-mean divides by the delivered count; the
            # scale turns that into the staleness-weighted mean
            state, info = server_fn(state, _scale_msg(msg_in, wn), aux,
                                    active=delivered)
        else:
            # fold delivery AND weighting into the message scale, so the
            # plain mean over all n clients is the weighted mean
            state, info = server_fn(
                state, _scale_msg(msg_in, wn * (n_clients / buffer_size)),
                aux)
        return state, info, resid

    def ledger(info, commit_time, delivered, age):
        info = dict(info)
        f32 = torch.float32
        info["vtime"] = commit_time
        d_age = torch.where(delivered, age, torch.zeros_like(age))
        # the reference's division by the constant buffer size is compiled
        # into a multiplication by its float32 reciprocal
        info["staleness_mean"] = (
            _edge_sum(d_age, edges).to(f32)
            * torch.tensor(np.float32(1) / np.float32(buffer_size),
                           device=age.device))
        info["staleness_max"] = torch.max(d_age).to(f32)
        hist = torch.zeros((AGE_HIST_BUCKETS,), dtype=f32, device=age.device)
        info["report_age_hist"] = hist.index_add_(
            0, torch.clamp(age, 0, AGE_HIST_BUCKETS - 1).long(),
            delivered.to(f32))
        return info

    def compress(comm_state, msg, draws, last_age):
        if tr_scheduled:
            return transport.compress(comm_state, msg, draws, ages=last_age)
        return transport.compress(comm_state, msg, draws)

    def wire_bytes(info, msg, last_age, sent):
        """Realized uplink bytes of this commit's transmissions (scheduled
        transports only: the fixed path's static accounting stays exact)."""
        if not tr_scheduled:
            return info
        per = transport.scheduled_bytes(msg, last_age)
        info = dict(info)
        info["uplink_bytes"] = torch.sum(
            torch.where(sent, per, torch.zeros_like(per))).to(torch.float32)
        return info

    def finish(state, sched, comm_state, dl_state, info, draws):
        if downlink is not None:
            _, dl_state = downlink.broadcast(dl_state, server_fields_fn(state),
                                             draws)
        return state, sched, comm_state, dl_state, info

    if queue_depth is not None:
        return _make_queued_step(
            local_fn, transport, buffer_size, n_clients, queue_depth, edges,
            visible, durations, compress, commit, ledger, wire_bytes, finish)

    def step(state, sched: AsyncState, comm_state, batch, dl_state=None, *,
             draws=None, clock_draws=None):
        # --- 1. refresh: everyone who re-synced at the last commit computes
        # its next report from the current broadcast state (the local half
        # runs for all clients; the fresh columns of clients still computing
        # are discarded, a simulation-only overcompute)
        refresh = sched.need_refresh
        dev = refresh.device
        st_v = visible(state, dl_state)
        msg_new, aux_new = local_fn(st_v, batch)
        msg_hat, cs_new = compress(comm_state, msg_new, draws, sched.last_age)
        comp, upl = durations(sched, clock_draws, dev)
        # the one-slot buffer never queues uploads: the streams just add
        dur = comp + upl
        if full_buffer:
            # every client delivered at the last commit, so every slot is
            # refreshed: no per-client select (the zero-delay bitwise
            # contract)
            comm_state = cs_new
            pending_msg, pending_aux = msg_hat, aux_new
            deliver_time = sched.vtime + dur
        else:
            # only refreshing clients compressed a report this step: the
            # others' error feedback must not advance
            comm_state = transport.select_clients(refresh, cs_new, comm_state)
            pending_msg = _where_clients(refresh, msg_hat, sched.pending_msg)
            pending_aux = _where_clients(refresh, aux_new, sched.pending_aux)
            deliver_time = torch.where(refresh, sched.vtime + dur,
                                       sched.deliver_time)

        # --- 2. commit: the buffer_size earliest arrivals form the buffer
        if full_buffer:
            commit_time = torch.max(deliver_time)
            delivered = torch.ones((n_clients,), dtype=torch.bool, device=dev)
        else:
            idx, commit_time = _earliest_k(deliver_time, buffer_size, edges)
            delivered = _delivered_mask(idx, n_clients, dev)
        age = sched.round_idx - pending_aux["round"].to(torch.int32)

        resid = sched.resid
        if full_buffer:
            # every report delivers at age zero: the unscaled server half IS
            # the synchronous round (with correction on, w = 1 retains
            # nothing, so the residual is skipped)
            state, info = server_fn(st_v, pending_msg, pending_aux)
            info = dict(info)
            f32 = torch.float32
            info["vtime"] = commit_time
            info["staleness_mean"] = torch.zeros((), dtype=f32, device=dev)
            info["staleness_max"] = torch.zeros((), dtype=f32, device=dev)
            hist = torch.zeros((AGE_HIST_BUCKETS,), dtype=f32, device=dev)
            hist[0] = buffer_size
            info["report_age_hist"] = hist
            last_synced = sched.round_idx.expand(n_clients).clone()
            last_age = sched.last_age
        else:
            # --- 3. staleness weighting (+ optional correction)
            state, info, resid = commit(st_v, pending_msg, pending_aux,
                                        resid, delivered, age)
            info = ledger(info, commit_time, delivered, age)
            last_synced = torch.where(delivered, sched.round_idx,
                                      sched.last_synced)
            last_age = torch.where(delivered, age, sched.last_age)
        info = wire_bytes(info, msg_new, sched.last_age,
                          torch.ones_like(refresh) if full_buffer
                          else refresh)
        sched = AsyncState(
            pending_msg=pending_msg, pending_aux=pending_aux, resid=resid,
            deliver_time=deliver_time,
            need_refresh=delivered,  # delivered clients re-sync now
            last_synced=last_synced, last_age=last_age, vtime=commit_time,
            round_idx=sched.round_idx + 1)
        return finish(state, sched, comm_state, dl_state, info, draws)

    return step


def _make_queued_step(local_fn, transport, buffer_size, n_clients, queue_depth,
                      edges, visible, durations, compress, commit, ledger,
                      wire_bytes, finish):
    """The multi-slot (:class:`QueueState`) step; see
    :func:`make_async_round`.

    Per commit: every client with a free slot computes a fresh report and
    enqueues it (full queues block; their fresh column is discarded).  A
    report finishes computing at ``vtime + compute`` but its upload cannot
    start before the client's in-flight uploads drain (FIFO).  The server
    selects the ``buffer_size`` earliest per-client queue heads, commits,
    and frees the delivered slots.  With ``queue_depth=1`` a slot is free
    exactly when the previous report was delivered: the one-slot path.
    """

    def step(state, sched: QueueState, comm_state, batch, dl_state=None, *,
             draws=None, clock_draws=None):
        st_v = visible(state, dl_state)
        filled = sched.slot_filled
        dev = filled.device
        # --- 1. enqueue: clients with a free slot compute a fresh report
        free = ~torch.all(filled, dim=0)             # (n,) can enqueue now
        # first free slot: argmin of a bool column, the lowest index on ties
        slot = torch.argmin(filled.to(torch.uint8), dim=0)
        msg_new, aux_new = local_fn(st_v, batch)
        msg_hat, cs_new = compress(comm_state, msg_new, draws, sched.last_age)
        comm_state = transport.select_clients(free, cs_new, comm_state)
        comp, upl = durations(sched, clock_draws, dev)
        neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
        busy = torch.max(torch.where(filled, sched.deliver_time, neg_inf),
                         dim=0).values
        arrive = torch.maximum(sched.vtime + comp, busy) + upl
        put = ((torch.arange(queue_depth, device=dev)[:, None]
                == slot[None, :]) & free)

        def enq(buf, new):
            m = put.reshape(tuple(put.shape) + (1,) * (buf.ndim - 2))
            return torch.where(m, new[None], buf)

        pending_msg = tu.tree_map(enq, sched.pending_msg, msg_hat)
        pending_aux = tu.tree_map(enq, sched.pending_aux, aux_new)
        deliver_time = torch.where(put, arrive[None], sched.deliver_time)
        filled = filled | put

        # --- 2. commit: the buffer_size earliest per-client queue heads
        inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
        t = torch.where(filled, deliver_time, inf)
        head_time = torch.min(t, dim=0).values
        head_slot = torch.argmin(t, dim=0)  # the lowest slot on ties
        idx, commit_time = _earliest_k(head_time, buffer_size, edges)
        delivered = _delivered_mask(idx, n_clients, dev)

        def take_head(buf):
            sl = head_slot.reshape((1, n_clients) + (1,) * (buf.ndim - 2))
            sl = sl.expand((1,) + tuple(buf.shape[1:]))
            return torch.gather(buf, 0, sl)[0]

        head_msg = tu.tree_map(take_head, pending_msg)
        head_aux = tu.tree_map(take_head, pending_aux)
        age = sched.round_idx - head_aux["round"].to(torch.int32)
        state, info, resid = commit(st_v, head_msg, head_aux, sched.resid,
                                    delivered, age)

        # --- 3. free the delivered heads
        pop = ((torch.arange(queue_depth, device=dev)[:, None]
                == head_slot[None, :]) & delivered)
        filled = filled & ~pop
        deliver_time = torch.where(pop, inf, deliver_time)

        info = ledger(info, commit_time, delivered, age)
        info = wire_bytes(info, msg_new, sched.last_age, free)
        sched = QueueState(
            pending_msg=pending_msg, pending_aux=pending_aux, resid=resid,
            slot_filled=filled, deliver_time=deliver_time,
            last_synced=torch.where(delivered, sched.round_idx,
                                    sched.last_synced),
            last_age=torch.where(delivered, age, sched.last_age),
            vtime=commit_time, round_idx=sched.round_idx + 1)
        return finish(state, sched, comm_state, dl_state, info, draws)

    return step
