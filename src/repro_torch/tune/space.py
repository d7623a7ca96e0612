"""The typed search space the autotuner walks: points are `EngineConfig`s.

The port of :mod:`repro.tune.space`.  The engine's optimum depends on the
configuration (chunk size, per-leaf against global top-k, the plane), so
the tunable axes are the levers the engine exposes: chunk size x transport
x ratio x granularity x buffer_size x queue_depth x staleness x plane --
plus the staleness-adaptive ratio schedule (:mod:`repro_torch.comm.schedule`)
on async workloads.

A :class:`TrialPoint` is a *canonical* coordinate: axes that cannot matter
for a given point are pinned to their defaults (dense transport has no
ratio; a synchronous workload has no buffer/queue/staleness/schedule), so
equivalent configurations collapse to one point and the search never
spends two measured trials on the same engine.  :class:`Workload` is the
problem the trials run -- the paper's sparse-logreg synthetic by default
-- and decides whether the asynchrony axes are live.

The proposals (:meth:`SearchSpace.sample`, :meth:`~SearchSpace.neighbors`,
:meth:`~SearchSpace.initial_candidates`) draw only from the
``np.random.Generator`` they are given, so for equal seeds they propose the
reference's point sequence.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, replace
from typing import Tuple

TRANSPORTS = ("dense", "topk", "randk", "quantize")
SCHEDULES = ("constant", "linear", "bucketed")
WIRE_MODES = ("blocking", "overlapped")


@dataclass(frozen=True)
class Workload:
    """The measured problem: the paper's heterogeneous sparse-logreg setup
    (:func:`repro_torch.fed.problems.logreg_problem`), optionally under a
    straggler clock (which activates the asynchrony axes)."""

    n_clients: int = 30
    m_per_client: int = 100
    dim: int = 20
    alpha: float = 50.0
    beta: float = 50.0
    data_seed: int = 0
    lam: float = 0.003
    tau: int = 10
    x64: bool = True
    clock: str = "none"          # "none" (synchronous) | "straggler"
    straggler_frac: float = 0.25
    slowdown: float = 4.0

    @property
    def is_async(self) -> bool:
        return self.clock != "none"

    def signature(self) -> dict:
        return dict(asdict(self), kind="logreg")


@dataclass(frozen=True)
class TrialPoint:
    """One canonical coordinate of the search space (see module docstring).

    ``buffer_frac`` is the FedBuff buffer as a fraction of the cohort
    (1.0 = wait for everyone); ``queue_depth=0`` keeps the one-slot
    buffer.  Both, plus ``staleness``/``schedule``, are live only on async
    workloads.  ``workers=0`` measures in-process; ``workers>0`` runs the
    trial through the multi-process runtime (:mod:`repro_torch.fed.runtime`,
    real bytes on a socket) with ``wire_mode`` choosing blocking vs
    overlapped uplink -- live only then (in-process trials have no wire).
    """

    chunk_rounds: int = 16
    transport: str = "dense"
    ratio: float = 1.0
    granularity: str = "leaf"
    plane: bool = False
    buffer_frac: float = 1.0
    queue_depth: int = 0
    staleness: str = "uniform"
    schedule: str = "constant"
    workers: int = 0
    wire_mode: str = "overlapped"

    def key(self) -> str:
        """Canonical JSON identity (dict-stable, hash-free)."""
        return json.dumps(asdict(self), sort_keys=True)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrialPoint":
        return cls(**d)

    def describe(self) -> str:
        bits = [f"chunk{self.chunk_rounds}", self.transport]
        if self.transport != "dense":
            bits.append(f"r{self.ratio:g}/{self.granularity}")
        if self.plane:
            bits.append("plane")
        if self.buffer_frac < 1.0:
            bits.append(f"buf{self.buffer_frac:g}")
        if self.queue_depth:
            bits.append(f"q{self.queue_depth}")
        if self.staleness != "uniform":
            bits.append(self.staleness)
        if self.schedule != "constant":
            bits.append(f"sched:{self.schedule}")
        if self.workers:
            bits.append(f"proc{self.workers}/{self.wire_mode}")
        return "+".join(bits)


@dataclass(frozen=True)
class SearchSpace:
    """Axis domains.  ``sample``/``neighbors`` only ever emit canonical
    points, and both draw exclusively from the injected rng, so the trial
    sequence is a pure function of the seed."""

    chunk_rounds: Tuple[int, ...] = (1, 4, 8, 16, 32)
    transport: Tuple[str, ...] = ("dense", "topk")
    ratio: Tuple[float, ...] = (0.1, 0.25, 0.5)
    granularity: Tuple[str, ...] = ("leaf", "global")
    plane: Tuple[bool, ...] = (False, True)
    buffer_frac: Tuple[float, ...] = (0.5, 1.0)
    queue_depth: Tuple[int, ...] = (0, 2)
    staleness: Tuple[str, ...] = ("uniform", "poly")
    schedule: Tuple[str, ...] = ("constant", "linear", "bucketed")
    # multi-process axes: singleton defaults keep the space in-process-only
    # (and its record signatures' shape); widen to e.g. workers=(0, 2) +
    # wire_mode=("blocking", "overlapped") to let the search trade wire
    # overlap against compute
    workers: Tuple[int, ...] = (0,)
    wire_mode: Tuple[str, ...] = ("overlapped",)

    def validate(self) -> None:
        for t in self.transport:
            if t not in TRANSPORTS:
                raise ValueError(f"unknown transport {t!r} in space "
                                 f"(valid: {TRANSPORTS})")
        for s in self.schedule:
            if s not in SCHEDULES:
                raise ValueError(f"unknown schedule {s!r} in space "
                                 f"(valid: {SCHEDULES})")
        for r in self.ratio:
            if not 0.0 < r <= 1.0:
                raise ValueError(f"ratio {r} outside (0, 1]")
        for m in self.wire_mode:
            if m not in WIRE_MODES:
                raise ValueError(f"unknown wire mode {m!r} in space "
                                 f"(valid: {WIRE_MODES})")
        for w in self.workers:
            if w < 0:
                raise ValueError(f"workers {w} must be >= 0")

    def signature(self) -> dict:
        """The cache-key identity of this space.  Axes still at their
        inert singleton defaults (``workers=(0,)``, the in-process-only
        space) are omitted, as the reference omits them."""
        sig = asdict(self)
        if tuple(sig["workers"]) == (0,):
            del sig["workers"]
            del sig["wire_mode"]
        return sig

    # -- canonicalization --------------------------------------------------

    def canonical(self, p: TrialPoint, workload: Workload) -> TrialPoint:
        """Pin every axis that cannot affect the engine for this point, so
        equivalent configs collapse to one coordinate."""
        if p.transport == "dense":
            p = replace(p, ratio=1.0, granularity="leaf")
        if p.transport == "quantize":
            p = replace(p, ratio=1.0)
        if p.transport in ("topk", "randk") and p.ratio not in self.ratio:
            # a mutation off dense inherits its pinned ratio=1.0; snap to
            # the nearest domain value so points stay inside the space
            p = replace(p, ratio=min(self.ratio,
                                     key=lambda r: abs(r - p.ratio)))
        if p.transport != "topk":
            p = replace(p, schedule="constant")
        if not workload.is_async:
            p = replace(p, buffer_frac=1.0, queue_depth=0,
                        staleness="uniform", schedule="constant")
        if workload.is_async and p.buffer_frac >= 1.0 and p.queue_depth == 0:
            # full buffer + one slot = the zero-delay regime: staleness and
            # the schedule never see a non-zero age
            p = replace(p, staleness="uniform", schedule="constant")
        if p.workers == 0:
            # no wire, no wire mode
            p = replace(p, wire_mode="overlapped")
        else:
            # the multi-process runtime runs synchronous engines over
            # dense/topk leaf-granular transports; pin what it cannot vary
            if p.transport not in ("dense", "topk"):
                p = replace(p, transport="dense", ratio=1.0)
            p = replace(p, granularity="leaf", buffer_frac=1.0,
                        queue_depth=0, staleness="uniform",
                        schedule="constant")
        return p

    def default_point(self, workload: Workload) -> TrialPoint:
        """The hand-picked baseline every search starts from: the engine's
        bench default (chunked, dense)."""
        return self.canonical(TrialPoint(), workload)

    # -- seeded proposal ---------------------------------------------------

    def sample(self, rng, workload: Workload) -> TrialPoint:
        def pick(xs):
            return xs[int(rng.integers(len(xs)))]

        return self.canonical(TrialPoint(
            chunk_rounds=pick(self.chunk_rounds),
            transport=pick(self.transport),
            ratio=pick(self.ratio),
            granularity=pick(self.granularity),
            plane=pick(self.plane),
            buffer_frac=pick(self.buffer_frac),
            queue_depth=pick(self.queue_depth),
            staleness=pick(self.staleness),
            schedule=pick(self.schedule),
            workers=pick(self.workers),
            wire_mode=pick(self.wire_mode),
        ), workload)

    def neighbors(self, p: TrialPoint, rng, workload: Workload,
                  tries: int = 32):
        """Seeded single-axis mutations of ``p`` (the hillclimb move set),
        deduplicated against ``p`` itself."""
        axes = {
            "chunk_rounds": self.chunk_rounds,
            "transport": self.transport,
            "ratio": self.ratio,
            "granularity": self.granularity,
            "plane": self.plane,
            "buffer_frac": self.buffer_frac,
            "queue_depth": self.queue_depth,
            "staleness": self.staleness,
            "schedule": self.schedule,
            "workers": self.workers,
            "wire_mode": self.wire_mode,
        }
        names = sorted(axes)
        for _ in range(tries):
            name = names[int(rng.integers(len(names)))]
            dom = axes[name]
            val = dom[int(rng.integers(len(dom)))]
            q = self.canonical(replace(p, **{name: val}), workload)
            if q != p:
                yield q

    def initial_candidates(self, n: int, rng, workload: Workload):
        """The deterministic explore cohort: the default point first, then
        distinct seeded samples (rejection-deduplicated)."""
        out = [self.default_point(workload)]
        seen = {out[0]}
        guard = 0
        while len(out) < n and guard < 64 * n:
            guard += 1
            p = self.sample(rng, workload)
            if p not in seen:
                seen.add(p)
                out.append(p)
        return out[:n]


def engine_config_kwargs(p: TrialPoint, workload: Workload) -> dict:
    """EngineConfig keyword set for a trial point on a workload -- the one
    place a coordinate becomes an engine configuration (the runner and
    ``--autotune`` both build from here)."""
    from repro_torch.comm import RatioSchedule, ScheduledTopK, get_transport

    kw: dict = {"chunk_rounds": p.chunk_rounds, "plane": p.plane}
    if p.transport != "dense":
        if p.transport == "topk" and p.schedule != "constant":
            sched = RatioSchedule(
                ratio=p.ratio, kind=p.schedule,
                slope=0.25 * p.ratio if p.schedule == "linear" else 0.0,
                floor=max(0.01, 0.2 * p.ratio),
                buckets=(p.ratio, 0.5 * p.ratio, 0.25 * p.ratio)
                if p.schedule == "bucketed" else ())
            kw["transport"] = ScheduledTopK(schedule=sched,
                                            granularity=p.granularity)
        elif p.transport == "quantize":
            kw["transport"] = get_transport("quantize",
                                            granularity=p.granularity)
        else:
            kw["transport"] = get_transport(p.transport, ratio=p.ratio,
                                            granularity=p.granularity)
    if workload.is_async:
        from repro_torch.sched import Staleness, StragglerClock

        kw["clock"] = StragglerClock(
            straggler_frac=workload.straggler_frac,
            slowdown=workload.slowdown)
        n = workload.n_clients
        kw["buffer_size"] = max(1, min(n, int(round(p.buffer_frac * n))))
        kw["staleness"] = Staleness(weighting=p.staleness)
        if p.queue_depth:
            kw["queue_depth"] = p.queue_depth
    return kw
