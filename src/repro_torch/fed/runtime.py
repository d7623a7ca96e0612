"""Multi-process federated runtime: real bytes on the wire, overlapped.

The counterpart of :mod:`repro.fed.runtime`.  The client half and the
server half are separate OS processes and the uplink message crosses a
socket, framed by :mod:`repro_torch.comm.wire` -- in the reference's frames,
byte for byte, so a worker of either package talks to a server of the
other.

Topology
--------
One **server** process and N **worker** processes over TCP.  Each worker
owns a contiguous shard of the client population and runs the ordinary
:class:`repro_torch.exec.RoundEngine` over its shard, on its device (the
card unless ``device`` says otherwise) -- the same rounds and kernels as a
single-process run.  Per engine chunk the worker ships one CHUNK frame:

  * the chunk's compressed uplink messages (the transport's actual output,
    re-encoded sparse/palette per ``Transport.wire_encoding`` so top-k and
    quantize frames carry their *compressed* byte count);
  * the worker's committed server-role fields after the chunk (one
    d-vector for DProx);
  * the server commit version the worker last synced against.

The server records every arrival in a real-time
:class:`repro_torch.sched.ArrivalLedger`, ACKs, then commits:

  * ``N == 1``: the worker owns the trajectory; the server installs the
    committed fields verbatim -- the server state is **bitwise** the
    single-process trajectory -- and *replays* the server half over the
    received messages (with zeroed client-resident aux, which the
    server-role update never reads) as a drift check;
  * ``N > 1``: chunk-granular FedBuff -- the committed innovation of worker
    w against its base version is mixed in with weight
    ``(n_w / n_total) * staleness.weight(age)`` (host numpy arithmetic, the
    reference's).  Not a bitwise claim against single-process execution.

Overlap
-------
``mode="blocking"`` fetches, serializes and sends inside the engine's
uplink sink.  ``mode="overlapped"`` hands the chunk to a sender thread
through a depth-1 queue (the double buffer) and returns: the sender
fetches, serializes and sends chunk k while the compute thread enqueues
chunk k+1.  On the card the hand-off is a stream hand-off: the sink records
an event on the compute stream, and the sender's side stream waits for it,
copies the chunk into pinned host memory without blocking the compute
stream, and synchronises only itself.  Tensors are mutable, so the queue
item keeps the chunk's tensors alive until their copy has finished (the
engine never writes into them: the stacked messages are a fresh buffer and
every round builds a new state).  Overlapped equals blocking bitwise.

``--throttle-bw`` paces the sender to a target bandwidth (bytes stay real,
timing is padded).

Entry points: :func:`run_server` / :func:`run_worker` / :func:`run_replica`
/ :func:`run_local` / :func:`run_pair`, and the CLI (``python -m
repro_torch.fed.runtime --role pair --workers 1 --check-parity``).  Every
entry point runs on ``cuda`` unless ``RuntimeArgs.device`` (``--device``)
says otherwise, and raises without a card; no frame carries the device.
"""
from __future__ import annotations

import argparse
import os
import queue
import socket
import struct
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.comm import wire
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import tree as tu

__all__ = ["RuntimeArgs", "run_local", "run_server", "run_worker",
           "run_replica", "run_pair", "shard_bounds", "add_runtime_args"]


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass
class RuntimeArgs:
    """Everything both sides need to build identical problem + engine.

    The server and each worker construct the SAME algorithm/data/params
    from these fields (deterministic in the seeds), so only messages --
    never the problem -- cross the wire.  The reference's fields, plus
    ``device``.
    """

    # problem (the paper's sparse logistic regression, Section 4.1)
    clients: int = 16
    m: int = 64
    dim: int = 256
    alpha: float = 50.0
    beta: float = 50.0
    data_seed: int = 0
    lam: float = 1e-3
    x64: bool = True
    # algorithm
    tau: int = 4
    eta: float = 0.05
    eta_g: float = 2.0
    # engine / comm
    transport: str = "dense"
    ratio: float = 0.1
    # per-commit ratio schedule for topk (repro_torch.comm.schedule);
    # "constant" is bitwise the fixed-ratio transport (the runtime's
    # engines are synchronous, so the adaptive kinds run at the base ratio)
    schedule: str = "constant"
    bits: int = 8
    plane: bool = False
    chunk: int = 4
    rounds: int = 16
    batch_size: Optional[int] = None
    # runtime
    host: str = "127.0.0.1"
    port: int = 0
    workers: int = 1
    mode: str = "overlapped"  # blocking | overlapped
    encoding: str = "auto"    # auto | dense | sparse | palette
    throttle_bw: Optional[float] = None  # bytes/s pacing on the sender
    replay: bool = True       # server-side drift check (N == 1)
    # serving replicas: read-only processes fed every committed server
    # plane as T_SNAP frames (XOR-bit deltas against a per-connection
    # shadow, dense keyframe every keyframe_every versions); each replica
    # proves bitwise reconstruction against the server's final fields
    replicas: int = 0
    keyframe_every: int = 8
    timeout: float = 120.0
    # observability (repro_torch.obs): a trace path enables span recording
    # in EVERY process; workers ship their buffers in the BYE frame and the
    # server writes ONE merged Chrome trace-event JSON there.  The metrics
    # path makes the server append one JSONL line per commit plus a final
    # registry snapshot.
    trace: Optional[str] = None
    metrics_jsonl: Optional[str] = None
    # where this process's engine and server state live
    device: str = "cuda"


def shard_bounds(n_total: int, n_workers: int) -> list:
    """Contiguous client shard ``[lo, hi)`` per worker, remainder spread
    over the first shards."""
    base, rem = divmod(n_total, n_workers)
    out, lo = [], 0
    for w in range(n_workers):
        hi = lo + base + (1 if w < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


# the problem's data of the last build in this process: a worker and the
# single-process reference it is checked against often share a process
_DATA: dict = {}


def _data(a: RuntimeArgs):
    """The problem's features and labels (numpy), normalized as the
    reference's; deterministic in ``a``."""
    from repro_torch.data.synthetic import logistic_heterogeneous

    key = (a.clients, a.m, a.dim, a.alpha, a.beta, a.data_seed, a.x64)
    if key not in _DATA:
        _DATA.clear()
        data = logistic_heterogeneous(n_clients=a.clients, m_per_client=a.m,
                                      d=a.dim, alpha=a.alpha, beta=a.beta,
                                      seed=a.data_seed)
        scale = np.linalg.norm(data.features.reshape(-1, a.dim), axis=1).max()
        dt = np.float64 if a.x64 else np.float32
        data.features = (data.features / scale).astype(dt)
        data.labels = data.labels.astype(dt)
        _DATA[key] = data
    return _DATA[key]


def _problem(a: RuntimeArgs, *, with_data: bool = True):
    """(algorithm, grad_fn, data, params0) -- deterministic in ``a``, built
    identically by every process; params0 on ``a.device``.  The server
    passes ``with_data=False``: no result of its depends on the data (its
    state starts from params0 and then follows the frames), and at full
    width the features are 2.7 GB of float64 on the host."""
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.core.prox import L1
    from repro_torch.device import resolve_device
    from repro_torch.fed.simulator import DProxAlgorithm
    from repro_torch.models import logreg

    dev = resolve_device(a.device)
    tdt = torch.float64 if a.x64 else torch.float32
    alg = DProxAlgorithm(L1(lam=a.lam),
                         DProxConfig(tau=a.tau, eta=a.eta, eta_g=a.eta_g))
    params0 = {"w": torch.zeros(a.dim, dtype=tdt, device=dev),
               "b": torch.zeros((), dtype=tdt, device=dev)}
    data = _data(a) if with_data else None
    return alg, logreg.make_grad_fn(), data, params0


def _transport(a: RuntimeArgs):
    from repro_torch.comm import as_schedule, get_transport

    if a.transport == "topk" and a.schedule != "constant":
        return get_transport("topk_sched",
                             schedule=as_schedule(a.schedule, a.ratio))
    kw = {}
    if a.transport in ("topk", "randk"):
        kw["ratio"] = a.ratio
    elif a.transport == "quantize":
        kw["bits"] = a.bits
    return get_transport(a.transport, **kw)


def _engine(a: RuntimeArgs, n_clients: int):
    from repro_torch.exec import EngineConfig, RoundEngine

    alg, grad_fn, data, params0 = _problem(a)
    eng = RoundEngine(alg, grad_fn, n_clients,
                      EngineConfig(chunk_rounds=a.chunk,
                                   transport=_transport(a), plane=a.plane),
                      device=a.device)
    return eng, alg, grad_fn, data, params0


def _supplier(a: RuntimeArgs, data, lo: int, hi: int):
    """The shard's batches, cached on the engine's device: the same batches
    as the reference's host supplier (full-batch rounds are views of the
    cache, never a per-round copy of the shard)."""
    from repro_torch.exec.suppliers import ArraySupplier

    return ArraySupplier(
        {"a": data.features[lo:hi], "y": data.labels[lo:hi]},
        tau=a.tau, batch_size=a.batch_size, seed=a.data_seed,
        device_cache=True, device=a.device)


def _host_tree(tree):
    """A tree's leaves as host arrays, dicts in sorted-key order (the tree
    the reference's ``jax.tree_util.tree_map(np.asarray, ...)`` gives)."""
    return tu.canonical(tu.tree_map(wire._to_host, tree))


def _server_fields(algorithm, state) -> dict:
    """Server-role state fields as host trees (field -> host-leafed tree: a
    field like DProx's ``x_bar`` is itself a params tree)."""
    from repro_torch.exec.engine import server_state_fields

    return _host_tree(server_state_fields(algorithm, state))


# ---------------------------------------------------------------------------
# single-process reference
# ---------------------------------------------------------------------------


def run_local(a: RuntimeArgs, sink=None) -> dict:
    """The single-process trajectory every multi-process claim is pinned
    against.  ``sink``, if given, is installed as the engine's uplink tap."""
    eng, alg, grad_fn, data, params0 = _engine(a, a.clients)
    sup = _supplier(a, data, 0, a.clients)
    if sink is not None:
        eng.set_uplink_sink(sink)
    state = eng.init(params0)
    t0 = time.perf_counter()
    state, metrics = eng.run(state, sup, a.rounds, seed=0)
    wall = time.perf_counter() - t0
    return {"fields": _server_fields(alg, state), "metrics": metrics,
            "wall_s": wall, "rounds": a.rounds}


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------


class _UplinkSender:
    """The uplink half of the overlap pipeline (see module docstring).

    ``sink`` is what gets registered via ``RoundEngine.set_uplink_sink``;
    blocking mode does the fetch/serialize/send/ACK inline, overlapped mode
    hands the chunk (still on the device) to the sender thread through a
    depth-1 queue (the double buffer) and returns to the compute loop.
    """

    def __init__(self, sock, rank: int, algorithm, plane_spec, encoding: str,
                 mode: str, chunk: int, throttle_bw: Optional[float],
                 device: torch.device):
        self.sock = sock
        self.rank = rank
        self.algorithm = algorithm
        self.plane_spec = plane_spec  # SegmentSpec in plane mode, else None
        self.encoding = encoding
        self.mode = mode
        self.chunk = chunk
        self.throttle_bw = throttle_bw
        self.base_version = 0
        self.device = device
        # the sender's numbers live in a metrics registry (one schema,
        # snapshot-able); report() gives the reference's result keys
        self.metrics = obs_metrics.MetricsRegistry()
        self._m_bytes = self.metrics.counter("uplink/bytes")
        self._m_chunks = self.metrics.counter("uplink/chunks")
        # time the COMPUTE thread spent blocked handing off / sending
        self._m_wait = self.metrics.counter("uplink/send_wait_s")
        # time the wire path itself took (fetch + pack + send + ACK)
        self._m_busy = self.metrics.counter("uplink/sender_busy_s")
        self._err: Optional[BaseException] = None
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._side = None  # the sender's copy stream on the card
        if mode == "overlapped":
            if self.device.type == "cuda":
                self._side = torch.cuda.Stream(self.device)
            self._q = queue.Queue(maxsize=1)
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()
        elif mode != "blocking":
            raise ValueError(f"unknown runtime mode {mode!r}")

    # -- the engine-facing callback --------------------------------------

    def sink(self, start_round: int, msgs, state) -> None:
        if self._err is not None:
            raise RuntimeError("uplink sender died") from self._err
        with obs_trace.timed("uplink/wait", "uplink",
                             start_round=int(start_round)) as tm:
            if self._q is None:
                self._ship(start_round, msgs, state, None)
            else:
                ready = None
                if self._side is not None:
                    # the chunk is enqueued, not done: the sender's stream
                    # waits for this point of the compute stream
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(self.device))
                self._q.put((start_round, msgs, state, ready))
        self._m_wait.add(tm.seconds)

    # -- internals --------------------------------------------------------

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._ship(*item)
            except BaseException as e:  # surfaced on the compute thread
                self._err = e
                return
            finally:
                self._q.task_done()

    def _fetch(self, tree, ready):
        """The chunk's tensors as host arrays.  Blocking (``ready`` None): a
        plain synchronous fetch.  Overlapped on the card: pinned host
        buffers filled on the side stream once ``ready`` has passed; only
        the side stream is synchronised, the compute stream runs on."""
        if ready is None:
            return _host_tree(tree)
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            self._side.wait_event(ready)

            def copy(t):
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                return h.copy_(t, non_blocking=True)

            host = tu.tree_map(copy, tree)
        self._side.synchronize()
        return _host_tree(host)

    def _ship(self, start_round: int, msgs, state, ready) -> None:
        from repro_torch.exec.engine import server_state_fields

        t0 = time.perf_counter()
        with obs_trace.span("uplink/ship", "uplink",
                            start_round=int(start_round)) as sp:
            # the host fetch happens HERE (on the sender thread when
            # overlapped); everything below is plain host bytes
            with obs_trace.span("uplink/fetch_pack", "uplink"):
                host_msgs, committed = self._fetch(
                    (msgs, server_state_fields(self.algorithm, state)),
                    ready)
                if self.plane_spec is not None:
                    c = host_msgs.shape[0]  # (c, n, d_pad)
                    packed = wire.pack_plane(host_msgs, self.encoding)
                else:
                    c = tu.tree_leaves(host_msgs)[0].shape[0]
                    packed = wire.pack_message(host_msgs, self.encoding)
            frame = {
                "worker": self.rank,
                "start_round": int(start_round),
                "rounds": int(c),
                "base_version": int(self.base_version),
                "msgs": packed,
                "committed": committed,
            }
            nb = wire.send_frame(self.sock, wire.T_CHUNK, frame)
            sp.set(nbytes=nb, rounds=int(c))
            if self.throttle_bw:
                time.sleep(max(0.0, nb / self.throttle_bw
                               - (time.perf_counter() - t0)))
            ftype, ack = wire.recv_frame(self.sock)
            if ftype != wire.T_ACK:
                raise wire.WireError(f"expected ACK, got frame type {ftype}")
        self.base_version = ack["version"]
        self._m_bytes.add(nb)
        self._m_chunks.add(1)
        self._m_busy.add(time.perf_counter() - t0)

    def finish(self) -> None:
        """Flush the queue and surface any sender-thread failure."""
        if self._q is not None:
            self._q.put(None)
            self._thread.join()
        if self._err is not None:
            raise RuntimeError("uplink sender died") from self._err

    @property
    def bytes_sent(self) -> int:
        return int(self._m_bytes.value)

    @property
    def chunks(self) -> int:
        return int(self._m_chunks.value)

    @property
    def send_wait_s(self) -> float:
        return self._m_wait.value

    @property
    def sender_busy_s(self) -> float:
        return self._m_busy.value

    def report(self) -> dict:
        return {"mode": self.mode, "encoding": self.encoding,
                "chunks": self.chunks, "bytes_sent": self.bytes_sent,
                "send_wait_s": self.send_wait_s,
                "sender_busy_s": self.sender_busy_s}


def _connect(a: RuntimeArgs) -> socket.socket:
    deadline = time.monotonic() + a.timeout
    while True:
        try:
            sock = socket.create_connection((a.host, a.port), timeout=5.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(a.timeout)
            return sock
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)


def run_worker(a: RuntimeArgs, rank: int) -> dict:
    """One worker process: build the shard engine, stream chunks, return
    the worker report + the server's final result frame."""
    from repro_torch.core.plane import SegmentSpec
    from repro_torch.device import eval_shape

    lo, hi = shard_bounds(a.clients, a.workers)[rank]
    eng, alg, grad_fn, data, params0 = _engine(a, hi - lo)
    sup = _supplier(a, data, lo, hi)
    state = eng.init(params0)

    # the wire shape, computed before the first chunk (a shape-only pass);
    # sorted dicts, as jax.eval_shape returns them to the reference
    one_round = sup.sample_round(0, np.random.default_rng(0))
    local_fn = alg.make_local_fn(grad_fn)
    msg_spec, aux_spec = tu.canonical(eval_shape(local_fn, state, one_round))
    plane_spec = None
    if a.plane:
        plane_spec = SegmentSpec.from_tree(msg_spec, batch_dims=1)
    encoding = a.encoding
    if encoding == "auto":
        encoding = _transport(a).wire_encoding

    # install() is idempotent: in the in-process threaded topology the
    # server may already own the tracer, in which case this worker shares
    # it (one bundle; the merge dedupes by pid) and must NOT uninstall it
    owns_tracer = a.trace and not isinstance(obs_trace.get(),
                                             obs_trace.Tracer)
    tracer = obs_trace.install(f"worker{rank}") if a.trace else None
    sock = _connect(a)
    try:
        # the HELLO/ACK round trip doubles as the clock-offset estimate:
        # the server stamps its own clock into the ACK, and (assuming
        # symmetric latency) that stamp corresponds to the midpoint of our
        # send/recv window
        t_send = obs_trace.now()
        wire.send_frame(sock, wire.T_HELLO, {
            "worker": rank, "lo": lo, "hi": hi, "n_total": a.clients,
            "rounds": a.rounds, "chunk": a.chunk, "mode": a.mode,
            "encoding": encoding, "plane": a.plane,
            "spec": wire.spec_to_wire(plane_spec) if a.plane else None,
            "aux_spec": aux_spec,
        })
        ftype, hello_ack = wire.recv_frame(sock)
        t_recv = obs_trace.now()
        if ftype != wire.T_ACK:
            raise wire.WireError(f"expected HELLO ACK, got type {ftype}")
        if tracer is not None and "srv_now" in hello_ack:
            tracer.offset = obs_trace.clock_offset(
                t_send, t_recv, hello_ack["srv_now"])

        sender = _UplinkSender(sock, rank, alg, plane_spec, encoding,
                               a.mode, a.chunk, a.throttle_bw,
                               device=eng.device)
        eng.set_uplink_sink(sender.sink)
        t0 = time.perf_counter()
        state, metrics = eng.run(state, sup, a.rounds, seed=0)
        sender.finish()
        wall = time.perf_counter() - t0

        wire.send_frame(sock, wire.T_BYE, {
            "worker": rank, "report": sender.report(),
            "trace": (tracer.export_wire(device=True)
                      if tracer is not None else None)})
        ftype, result = wire.recv_frame(sock)
        if ftype != wire.T_RESULT:
            raise wire.WireError(f"expected RESULT, got type {ftype}")
    finally:
        sock.close()
        if tracer is not None and owns_tracer:
            obs_trace.uninstall()
    rep = sender.report()
    rep.update({"worker": rank, "lo": lo, "hi": hi, "wall_s": wall,
                "rounds": a.rounds, "metrics": metrics,
                "fields": _server_fields(alg, state),
                "server_result": result})
    return rep


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _ServerState:
    """Authoritative server-role fields + per-version snapshots + ledger."""

    def __init__(self, algorithm, a: RuntimeArgs):
        from repro_torch.sched import ArrivalLedger, Staleness
        from repro_torch.sched.aggregator import AGE_HIST_BUCKETS
        from repro_torch.serving import SnapshotStore

        _, _, _, params0 = _problem(a, with_data=False)
        state0 = algorithm.init(params0, a.clients)
        self.device = params0["w"].device
        self.algorithm = algorithm
        self.args = a
        self.fields = _server_fields(algorithm, state0)
        self.ledger = ArrivalLedger()
        self.staleness = Staleness()
        self.snapshots = {0: dict(self.fields)}
        self.rounds_done = 0
        self.max_drift = 0.0
        self.lock = threading.Lock()
        # the serving plane: every commit publishes its fields snapshot
        # (store versions track ledger versions one-to-one); replica
        # connections block on wait_for and stream deltas off it
        self.store = SnapshotStore()
        self.workers_left = a.workers
        self.finished = threading.Event()
        self._replay_step = None
        self._replay_state = state0 if (a.replay and a.workers == 1) else None
        # the unified metrics surface: commit-path counters/histograms land
        # here, one JSONL line per commit when a sink is attached
        self.metrics = obs_metrics.MetricsRegistry()
        self.sink = (obs_metrics.JsonlSink(a.metrics_jsonl)
                     if a.metrics_jsonl else None)
        self._m_bytes = self.metrics.counter("uplink/bytes")
        self._m_commits = self.metrics.counter("commits")
        self._m_age = self.metrics.histogram("arrival/age",
                                             buckets=AGE_HIST_BUCKETS)
        self._m_weight = self.metrics.gauge("commit/weight")
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- replay (the aux-independence check, N == 1) ----------------------

    def _replay(self, msgs_tree, spec, aux_spec, rounds: int) -> None:
        """Re-run the server half over the received messages with ZEROED
        client-resident aux.  The server-role update (DProx Lines 14-15)
        depends only on (state, message) -- aux feeds the client-side
        correction -- so the replayed x_bar tracks the worker's committed
        x_bar; the gap is reported as ``max_drift``."""
        from repro_torch.core import plane as pln

        dev = self.device

        def on_device(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        if self._replay_step is None:
            server_fn = self.algorithm.make_server_fn()
            zero_aux = tu.tree_map(
                lambda s: torch.zeros(tuple(s.shape), dtype=s.dtype,
                                      device=dev), aux_spec)
            self._replay_step = lambda st, m: server_fn(st, m, zero_aux)[0]
        st = self._replay_state
        for r in range(rounds):
            if spec is not None:
                msg = pln.unflatten(spec, on_device(msgs_tree[r]))
            else:
                msg = tu.tree_map(lambda l: on_device(l[r]), msgs_tree)
            st = self._replay_step(st, msg)
        self._replay_state = st

    def drift_vs(self, committed: dict) -> float:
        replayed = tu.tree_leaves(_server_fields(self.algorithm,
                                                 self._replay_state))
        diffs = [float(np.max(np.abs(r - c))) if np.size(c) else 0.0
                 for r, c in zip(replayed, tu.tree_leaves(committed))]
        return max(diffs, default=0.0)

    # -- commit -----------------------------------------------------------

    def commit(self, frame: dict, nbytes: int, spec, aux_spec) -> dict:
        """Apply one CHUNK frame; returns the ACK payload.  Caller holds
        no lock -- this takes it."""
        with self.lock, obs_trace.span(
                "server/commit", "server", worker=frame["worker"],
                start_round=frame["start_round"], nbytes=nbytes):
            arrival = self.ledger.record(
                frame["worker"], frame["start_round"], frame["rounds"],
                nbytes, frame["base_version"])
            committed = frame["committed"]
            n_w = self._shard_width(frame["worker"])
            w = 1.0
            if self.args.workers == 1:
                # single trajectory owner: install verbatim (bitwise)
                if self._replay_state is not None:
                    with obs_trace.span("server/replay", "server",
                                        rounds=frame["rounds"]):
                        self._replay(frame["msgs"], spec, aux_spec,
                                     frame["rounds"])
                    self.max_drift = max(self.max_drift,
                                         self.drift_vs(committed))
                self.fields = dict(committed)
            else:
                # chunk-granular FedBuff: mix the worker's innovation
                # against its base snapshot, staleness-weighted
                base = self.snapshots.get(frame["base_version"],
                                          self.fields)
                w = ((n_w / self.args.clients)
                     * float(self.ledger.weights_for([arrival],
                                                     self.staleness)[0]))
                self.fields = tu.canonical(tu.tree_map(
                    lambda cur, com, b: cur + w * (com - b),
                    self.fields, committed, base))
            version = self.ledger.bump()
            self.snapshots[version] = dict(self.fields)
            self.rounds_done = max(self.rounds_done,
                                   frame["start_round"] + frame["rounds"])
            self.store.publish(self.snapshots[version],
                               round=self.rounds_done)
            t = obs_trace.now()
            if self._t_first is None:
                self._t_first = t
            self._t_last = t
            self._m_bytes.add(nbytes)
            self._m_commits.add(1)
            self._m_age.observe(arrival.age)
            self._m_weight.set(w)
            if self.sink is not None:
                self.sink.write("commit", worker=frame["worker"],
                                version=version, start_round=frame[
                                    "start_round"],
                                rounds=frame["rounds"], nbytes=nbytes,
                                age=arrival.age, weight=w)
            return {"version": version, "age": arrival.age,
                    "t": arrival.t}

    def _shard_width(self, rank: int) -> int:
        lo, hi = shard_bounds(self.args.clients, self.args.workers)[rank]
        return hi - lo

    def result(self) -> dict:
        with self.lock:
            if self._t_first is not None and self._t_last > self._t_first:
                self.metrics.gauge("round_throughput").set(
                    self.rounds_done / (self._t_last - self._t_first))
            return {"fields": self.fields, "version": self.ledger.version,
                    "rounds_done": self.rounds_done,
                    "max_replay_drift": self.max_drift,
                    "ledger": self.ledger.summary(),
                    "age_histogram": self.ledger.age_histogram(),
                    "metrics": self.metrics.snapshot()}


def _serve_conn(conn, srv: _ServerState, reports: dict,
                traces: Optional[dict] = None) -> None:
    """One worker OR replica connection, dispatched on its HELLO.  Runs on
    its own thread; the commit path serializes on the server-state lock."""
    try:
        ftype, hello = wire.recv_frame(conn, expect=wire.T_HELLO)
        if hello.get("replica") is not None:
            _serve_replica(conn, srv, hello, reports)
            return
        spec = (wire.spec_from_wire(hello["spec"])
                if hello["spec"] is not None else None)
        aux_spec = hello["aux_spec"]
        # srv_now is the worker's clock-offset reference (see run_worker)
        wire.send_frame(conn, wire.T_ACK, {"version": srv.ledger.version,
                                           "srv_now": obs_trace.now()})
        while True:
            with obs_trace.span("wire/recv", "wire") as sp:
                buf = _recv_raw_frame(conn)
                sp.set(nbytes=len(buf))
            with obs_trace.span("wire/decode", "wire", nbytes=len(buf)):
                ftype, tree, _ = wire.decode_frame(
                    buf, expect=(wire.T_CHUNK, wire.T_BYE))
            if ftype == wire.T_BYE:
                reports[tree["worker"]] = tree.get("report", {})
                if traces is not None and tree.get("trace") is not None:
                    traces[tree["worker"]] = tree["trace"]
                with srv.lock:
                    srv.workers_left -= 1
                    if srv.workers_left <= 0:
                        srv.finished.set()
                break
            msgs = (wire.unpack_plane(tree["msgs"]) if spec is not None
                    else wire.unpack_message(tree["msgs"]))
            frame = dict(tree)
            frame["msgs"] = msgs
            ack = srv.commit(frame, len(buf), spec, aux_spec)
            wire.send_frame(conn, wire.T_ACK, ack)
        wire.send_frame(conn, wire.T_RESULT, srv.result())
    finally:
        conn.close()


def _serve_replica(conn, srv: _ServerState, hello: dict,
                   reports: dict) -> None:
    """One replica connection: stream every committed serving snapshot as
    a T_SNAP frame (delta against this connection's shadow, keyframe per
    the cadence), then the final RESULT the replica proves itself against.

    A late joiner is fine: the first frame any publisher emits is a dense
    keyframe, and a delta's base is whatever was last shipped on THIS
    connection -- versions skipped while encoding lags behind commits are
    bridged by a single delta, never a gap.
    """
    from repro_torch.serving import DeltaPublisher

    a = srv.args
    enc = a.encoding if a.encoding in wire.PLANE_ENCODINGS else "sparse"
    pub = DeltaPublisher(keyframe_every=a.keyframe_every, encoding=enc)
    rank = hello["replica"]
    wire.send_frame(conn, wire.T_ACK, {"version": srv.ledger.version,
                                       "srv_now": obs_trace.now()})
    sent = 0
    nbytes = 0
    next_v = 1
    while True:
        snap = srv.store.wait_for(next_v, timeout=0.05)
        if snap is None:
            if srv.finished.is_set() and srv.store.version < next_v:
                break
            continue
        frame = pub.encode(snap)
        with obs_trace.span("serve/snap_send", "serve",
                            version=snap.version, kind=frame["kind"]) as sp:
            nb = wire.send_frame(conn, wire.T_SNAP, frame)
            sp.set(nbytes=nb)
        nbytes += nb
        sent += 1
        next_v = snap.version + 1
    reports[f"replica{rank}"] = {"frames": sent, "bytes_sent": nbytes,
                                 "last_version": next_v - 1}
    wire.send_frame(conn, wire.T_RESULT, srv.result())


def run_replica(a: RuntimeArgs, rank: int = 0) -> dict:
    """One replica process: subscribe to the server's snapshot feed, apply
    every T_SNAP frame (keyframe or XOR delta, digest-checked), and verify
    the final reconstructed plane bitwise against the server's RESULT.
    Host work only: a replica touches no device."""
    from repro_torch.serving import DeltaReplica

    sock = _connect(a)
    rep = DeltaReplica()
    nbytes = 0
    keyframes = 0
    try:
        wire.send_frame(sock, wire.T_HELLO,
                        {"replica": rank, "n_total": a.clients})
        wire.recv_frame(sock, expect=wire.T_ACK)
        while True:
            buf = _recv_raw_frame(sock)
            ftype, tree, _ = wire.decode_frame(
                buf, expect=(wire.T_SNAP, wire.T_RESULT))
            if ftype == wire.T_RESULT:
                result = tree
                break
            nbytes += len(buf)
            keyframes += int(tree["kind"] == "key")
            rep.apply(tree)
    finally:
        sock.close()
    ok = rep.plane is not None and _fields_bitwise(rep.plane,
                                                   result["fields"])
    return {"replica": rank, "ok": ok, "applied": rep.applied,
            "skipped": rep.skipped, "version": rep.version,
            "keyframes": keyframes, "bytes_received": nbytes,
            "server_result": result}


def _recv_raw_frame(sock) -> bytes:
    """Receive one frame's raw bytes (header + payload) so the server can
    account exact wire bytes before decoding."""
    hdr = wire._recv_exact(sock, wire.HEADER_BYTES)
    length = struct.unpack(">Q", hdr[-8:])[0]
    if length > wire.MAX_PAYLOAD:
        raise wire.WireError(f"frame claims {length} payload bytes")
    return hdr + wire._recv_exact(sock, length)


def run_server(a: RuntimeArgs, *, ready_cb=None) -> dict:
    """The server process: accept ``a.workers + a.replicas`` connections
    (each dispatched on its HELLO), drive workers to BYE and replicas to
    the end of the snapshot stream, return the final result (also what
    each worker and replica receives)."""
    owns_tracer = a.trace and not isinstance(obs_trace.get(),
                                             obs_trace.Tracer)
    alg = _problem(a, with_data=False)[0]
    srv = _ServerState(alg, a)
    tracer = obs_trace.install("server") if a.trace else None
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind((a.host, a.port))
    lsock.listen(a.workers + a.replicas)
    lsock.settimeout(a.timeout)
    port = lsock.getsockname()[1]
    if ready_cb is not None:
        ready_cb(port)
    reports: dict = {}
    traces: dict = {}
    threads = []
    try:
        for _ in range(a.workers + a.replicas):
            conn, _addr = lsock.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(a.timeout)
            t = threading.Thread(target=_serve_conn,
                                 args=(conn, srv, reports, traces),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(a.timeout)
            if t.is_alive():
                raise TimeoutError("worker connection did not complete")
    finally:
        lsock.close()
    out = srv.result()
    out["worker_reports"] = reports
    out["port"] = port
    if srv.sink is not None:
        srv.sink.write_snapshot(srv.metrics, rounds_done=srv.rounds_done)
        srv.sink.close()
    if tracer is not None:
        # the merge: server spans (offset 0 -- the reference clock) + every
        # worker's shipped bundle, already offset onto this timebase.  The
        # server bundle goes first so merge_wire's pid dedupe keeps the
        # complete in-process bundle when a threaded worker shares it.
        doc = obs_trace.to_chrome([tracer.export_wire(device=True)]
                                  + [traces[w] for w in sorted(traces)])
        obs_trace.write_chrome(doc, a.trace)
        out["trace_path"] = a.trace
        if owns_tracer:
            obs_trace.uninstall()
    return out


# ---------------------------------------------------------------------------
# pair launcher (server subprocess + workers; rank 0 inline)
# ---------------------------------------------------------------------------


def _free_port(host: str) -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(a: RuntimeArgs, role: str, rank: int = 0) -> subprocess.Popen:
    argv = [sys.executable, "-m", "repro_torch.fed.runtime",
            "--role", role, "--rank", str(rank)] + _to_argv(a)
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))]
        + ([env["PYTHONPATH"]] if "PYTHONPATH" in env else [])))
    return subprocess.Popen(argv, env=env)


def run_pair(a: RuntimeArgs) -> dict:
    """Server subprocess + ``a.workers`` workers (rank 0 runs in this
    process so its report and exceptions surface directly) + ``a.replicas``
    replica subprocesses."""
    if a.port == 0:
        a.port = _free_port(a.host)
    procs = [_spawn(a, "server")]
    try:
        procs += [_spawn(a, "worker", rank=w) for w in range(1, a.workers)]
        procs += [_spawn(a, "replica", rank=r) for r in range(a.replicas)]
        rep = run_worker(a, rank=0)
        for p in procs:
            rc = p.wait(timeout=a.timeout)
            if rc != 0:
                raise RuntimeError(f"runtime subprocess exited with {rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rep


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def add_runtime_args(ap: argparse.ArgumentParser) -> None:
    """The runtime's own flags (the reference's, plus ``--device``)."""
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--eta-g", type=float, default=2.0)
    ap.add_argument("--lam", type=float, default=1e-3)
    ap.add_argument("--transport", default="dense",
                    choices=["dense", "topk", "randk", "quantize"])
    ap.add_argument("--ratio", type=float, default=0.1)
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "linear", "bucketed"],
                    help="per-commit topk ratio schedule "
                         "(repro_torch.comm.schedule; constant == fixed "
                         "ratio)")
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--plane", action="store_true")
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--mode", default="overlapped",
                    choices=["blocking", "overlapped"])
    ap.add_argument("--encoding", default="auto",
                    choices=["auto"] + list(wire.PLANE_ENCODINGS))
    ap.add_argument("--throttle-bw", type=float, default=None,
                    help="pace the sender to this bandwidth (bytes/s)")
    ap.add_argument("--no-replay", action="store_true",
                    help="skip the server-side replay drift check")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serving replicas fed delta-compressed snapshot "
                    "frames (each verifies bitwise reconstruction)")
    ap.add_argument("--keyframe-every", type=int, default=8,
                    help="dense keyframe cadence on the replica feed")
    ap.add_argument("--x32", action="store_true",
                    help="run in float32 (default float64)")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record spans in every process and write ONE "
                    "merged Chrome trace-event JSON here (open in "
                    "Perfetto)")
    ap.add_argument("--metrics-jsonl", default=None, metavar="OUT.jsonl",
                    help="server appends one JSONL line per commit plus a "
                    "final metrics snapshot")
    ap.add_argument("--device", default="cuda",
                    help="device of this process's engine and server state "
                    "(default cuda; cpu runs on the host)")


def _from_ns(ns: argparse.Namespace) -> RuntimeArgs:
    return RuntimeArgs(
        clients=ns.clients, m=ns.m, dim=ns.dim, tau=ns.tau, eta=ns.eta,
        eta_g=ns.eta_g, lam=ns.lam, x64=not ns.x32, transport=ns.transport,
        ratio=ns.ratio, schedule=ns.schedule, bits=ns.bits,
        plane=ns.plane, chunk=ns.chunk,
        rounds=ns.rounds, batch_size=ns.batch_size, host=ns.host,
        port=ns.port, workers=ns.workers, mode=ns.mode,
        encoding=ns.encoding, throttle_bw=ns.throttle_bw,
        replay=not ns.no_replay, replicas=ns.replicas,
        keyframe_every=ns.keyframe_every, timeout=ns.timeout,
        trace=ns.trace, metrics_jsonl=ns.metrics_jsonl, device=ns.device)


def _to_argv(a: RuntimeArgs) -> list:
    argv = ["--clients", str(a.clients), "--m", str(a.m),
            "--dim", str(a.dim), "--tau", str(a.tau), "--eta", str(a.eta),
            "--eta-g", str(a.eta_g), "--lam", str(a.lam),
            "--transport", a.transport, "--ratio", str(a.ratio),
            "--schedule", a.schedule,
            "--bits", str(a.bits), "--chunk", str(a.chunk),
            "--rounds", str(a.rounds), "--host", a.host,
            "--port", str(a.port), "--workers", str(a.workers),
            "--mode", a.mode, "--encoding", a.encoding,
            "--replicas", str(a.replicas),
            "--keyframe-every", str(a.keyframe_every),
            "--timeout", str(a.timeout), "--device", a.device]
    if a.batch_size is not None:
        argv += ["--batch-size", str(a.batch_size)]
    if a.throttle_bw is not None:
        argv += ["--throttle-bw", str(a.throttle_bw)]
    if a.trace is not None:
        argv += ["--trace", a.trace]
    if a.metrics_jsonl is not None:
        argv += ["--metrics-jsonl", a.metrics_jsonl]
    if a.plane:
        argv.append("--plane")
    if not a.replay:
        argv.append("--no-replay")
    if not a.x64:
        argv.append("--x32")
    return argv


def _leaf_bits(x) -> tuple:
    h = wire._to_host(x)
    u, name = wire._bits(h)
    return name, tuple(h.shape), u.tobytes()


def _fields_bitwise(x, y) -> bool:
    """Same tree structure and the same dtype, shape and bytes in every
    leaf."""
    xl, xd = tu.tree_flatten(x)
    yl, yd = tu.tree_flatten(y)
    return xd == yd and all(_leaf_bits(p) == _leaf_bits(q)
                            for p, q in zip(xl, yl))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="multi-process federated runtime (see module docstring)")
    ap.add_argument("--role", default="pair",
                    choices=["local", "server", "worker", "replica",
                             "pair"])
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--check-parity", action="store_true",
                    help="(pair, workers=1) also run single-process and "
                    "assert the server trajectory matches bitwise")
    add_runtime_args(ap)
    ns = ap.parse_args(argv)
    a = _from_ns(ns)

    if ns.role == "local":
        res = run_local(a)
        print(f"local: rounds={a.rounds} wall={res['wall_s']:.3f}s "
              f"loss={res['metrics']['train_loss'][-1]:.6f}")
        return 0
    if ns.role == "server":
        res = run_server(a)
        print(f"server: version={res['version']} "
              f"rounds={res['rounds_done']} "
              f"drift={res['max_replay_drift']:.3e} "
              f"ledger={res['ledger']}")
        return 0
    if ns.role == "worker":
        rep = run_worker(a, rank=ns.rank)
        print(f"worker[{ns.rank}]: wall={rep['wall_s']:.3f}s "
              f"sent={rep['bytes_sent']}B wait={rep['send_wait_s']:.3f}s")
        return 0
    if ns.role == "replica":
        rep = run_replica(a, rank=ns.rank)
        print(f"replica[{ns.rank}]: applied={rep['applied']} "
              f"keyframes={rep['keyframes']} recv={rep['bytes_received']}B "
              f"v{rep['version']} "
              f"reconstruction={'BITWISE' if rep['ok'] else 'MISMATCH'}")
        return 0 if rep["ok"] else 1
    # pair
    rep = run_pair(a)
    res = rep["server_result"]
    print(f"pair: workers={a.workers} mode={a.mode} rounds={a.rounds} "
          f"wall={rep['wall_s']:.3f}s sent={rep['bytes_sent']}B "
          f"wait={rep['send_wait_s']:.3f}s "
          f"drift={res['max_replay_drift']:.3e}")
    if a.trace:
        print(f"trace: {a.trace} (merged Chrome trace-event JSON)")
    if a.metrics_jsonl:
        print(f"metrics: {a.metrics_jsonl}")
    if ns.check_parity:
        if a.workers != 1:
            print("parity check needs --workers 1", file=sys.stderr)
            return 2
        local = run_local(a)
        ok = _fields_bitwise(local["fields"], res["fields"])
        print(f"parity: {'BITWISE' if ok else 'MISMATCH'}")
        if not ok:
            diffs = [float(np.max(np.abs(np.asarray(p, np.float64)
                                         - np.asarray(q, np.float64))))
                     for p, q in zip(tu.tree_leaves(local["fields"]),
                                     tu.tree_leaves(res["fields"]))]
            print(f"  max|diff| per leaf: {diffs}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
