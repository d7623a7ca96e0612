"""Measured trials: run a TrialPoint for a few chunks, score it from obs.

The port of :mod:`repro.tune.runner`.  The objective is read from
:mod:`repro_torch.obs` instruments -- a
:class:`~repro_torch.obs.metrics.MetricsRegistry` snapshot plus a local
:class:`~repro_torch.obs.trace.Tracer` span around the measured run (the
tuner keeps no ad-hoc timers).  Per trial the runner populates:

  * gauge ``tune/round_us``          -- wall time per round (the trial span,
    closed after the device has finished the run's work)
  * gauge ``tune/bytes_per_client_round`` -- measured uplink bytes
    (``uplink_bytes`` metric for scheduled transports, the transport's
    static per-client cost otherwise, dense d-vector cost with no uplink
    stage)
  * gauge ``tune/staleness_mean``    -- mean commit staleness (async only)
  * histogram ``tune/arrival_age``   -- the engine's ``report_age_hist``
    rounds, folded via ``Histogram.merge_counts``
  * gauge ``tune/hidden_fraction``   -- wire-behind-compute fraction from
    ``obs.report.overlap_report`` (multi-process trials only)

and the scalar objective is computed *from the snapshot* by
:meth:`TrialRunner.score`: microseconds per round plus a bytes tax
(``bytes_weight`` us/byte, so a config only wins by spending bytes if the
bytes buy more time than they cost) plus a staleness tax.

Trials run on ``device`` (``cuda`` unless given), so a trial on the card
launches the port's kernels: the fused local update every local step, the
threshold select or the quantizer for compressed uplinks, the weighted
commit for async commits on the plane.  The clock's draws of an async
workload are made on the CPU and copied to the device, so a trial's
staleness is the same on the card and on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.tune.space import TrialPoint, Workload, engine_config_kwargs


@dataclass(frozen=True)
class TrialResult:
    point: TrialPoint
    objective: float
    round_us: float
    bytes_per_client_round: float
    staleness_mean: float
    rounds: int
    snapshot: Dict[str, Any] = field(default_factory=dict, repr=False)

    def to_dict(self) -> dict:
        return {"point": self.point.to_dict(),
                "objective": round(self.objective, 3),
                "round_us": round(self.round_us, 3),
                "bytes_per_client_round":
                    round(self.bytes_per_client_round, 1),
                "staleness_mean": round(self.staleness_mean, 4),
                "rounds": self.rounds}


def _dense_bytes_per_client(params0) -> int:
    from repro_torch.utils.tree import tree_leaves

    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(params0))


class TrialRunner:
    """Builds the workload's problem once, then measures TrialPoints.

    ``rounds`` is the measured run length per trial (after a one-chunk
    warm-up, which on a fresh machine also builds the kernels); ``reps``
    takes the best-of-N to shave scheduler noise.  The search layer treats
    the runner as an injectable callable (``runner.measure(point)``), which
    is how tests substitute an analytic fake.
    """

    def __init__(self, workload: Workload, *, rounds: int = 64,
                 reps: int = 2, batch_size: int = 4,
                 bytes_weight: float = 0.05, staleness_weight: float = 0.0,
                 processes: int = 0, device=None):
        self.workload = workload
        self.rounds = int(rounds)
        self.reps = int(reps)
        self.batch_size = int(batch_size)
        self.bytes_weight = float(bytes_weight)
        self.staleness_weight = float(staleness_weight)
        self.processes = int(processes)
        self.device = device
        self.measured_trials = 0
        self.last_trace = None  # the last multi-process trial's merged trace
        self._problem = None

    # -- problem ----------------------------------------------------------

    def _setup(self):
        if self._problem is not None:
            return self._problem
        from repro_torch.core.algorithm import DProxConfig
        from repro_torch.device import resolve_device
        from repro_torch.exec import ArraySupplier
        from repro_torch.fed.problems import logreg_problem
        from repro_torch.fed.simulator import DProxAlgorithm

        w = self.workload
        dev = resolve_device(self.device)
        data, reg, grad_fn, full_g, params0, L = logreg_problem(
            n_clients=w.n_clients, m=w.m_per_client, d=w.dim,
            alpha=w.alpha, beta=w.beta, seed=w.data_seed, lam=w.lam,
            x64=w.x64, device=dev)
        eta_g = 3.0
        eta = (0.5 / L) / (eta_g * w.tau)
        alg = DProxAlgorithm(reg, DProxConfig(tau=w.tau, eta=eta,
                                              eta_g=eta_g))
        sup = ArraySupplier.from_dataset(data, w.tau, self.batch_size,
                                         seed=3)
        self._problem = (dev, alg, grad_fn, data, params0, sup)
        return self._problem

    def _clock_draws(self):
        """The clock's draw source of an async trial: a generator on the
        CPU seeded with ``EngineConfig.clock_seed``, whatever the device
        (None: the engine's default, for synchronous workloads)."""
        from repro_torch.comm import GeneratorDraws
        from repro_torch.exec import EngineConfig

        if not self.workload.is_async:
            return None
        return GeneratorDraws(EngineConfig.clock_seed, "cpu")

    def _engine(self, point: TrialPoint):
        from repro_torch.exec import EngineConfig, RoundEngine

        dev, alg, grad_fn, data, params0, sup = self._setup()
        kw = engine_config_kwargs(point, self.workload)
        engine = RoundEngine(alg, grad_fn, data.n_clients,
                             EngineConfig(**kw), device=dev,
                             clock_draws=self._clock_draws())
        return engine, params0, sup

    # -- measurement ------------------------------------------------------

    def measure(self, point: TrialPoint) -> TrialResult:
        if point.workers or self.processes:
            return self._measure_processes(point)
        engine, params0, sup = self._engine(point)
        state = engine.init(params0)
        # warm-up (the kernels' build and first launches) outside the span
        state, _ = engine.run(state, sup, point.chunk_rounds, seed=1)
        _sync(engine.device)

        registry = _metrics.MetricsRegistry()
        tracer = _trace.Tracer("tune")
        best_s = float("inf")
        metrics = {}
        for _ in range(self.reps):
            with tracer.span("tune/trial", "tune",
                             point=point.describe()):
                state, metrics = engine.run(state, sup, self.rounds, seed=2)
                # a chunk with no metrics copies nothing to the host: the
                # span closes only once the device has finished the run
                _sync(engine.device)
            wire = tracer.export_wire()
            best_s = min(best_s, float(wire["t1"][-1] - wire["t0"][-1]))
        self.measured_trials += 1
        self._record_obs(registry, engine, params0, metrics, best_s)
        return self.score(point, registry.snapshot())

    def _record_obs(self, registry, engine, params0, metrics,
                    seconds: float) -> None:
        registry.gauge("tune/round_us").set(seconds / self.rounds * 1e6)
        if "uplink_bytes" in metrics:  # scheduled transport: measured bytes
            per_round = float(np.mean(metrics["uplink_bytes"]))
            bytes_pcr = per_round / engine.n_clients
        elif engine.uplink_bytes_per_client_round is not None:
            bytes_pcr = float(engine.uplink_bytes_per_client_round)
        else:  # no uplink stage: the dense d-vector crosses per round
            bytes_pcr = float(_dense_bytes_per_client(params0))
        registry.gauge("tune/bytes_per_client_round").set(bytes_pcr)
        stale = metrics.get("staleness_mean")
        registry.gauge("tune/staleness_mean").set(
            float(np.mean(stale)) if stale else 0.0)
        hist = registry.histogram("tune/arrival_age")
        for counts in metrics.get("report_age_hist", []):
            hist.merge_counts(np.asarray(counts))

    def _measure_processes(self, point: TrialPoint) -> TrialResult:
        """Multi-process trial via :mod:`repro_torch.fed.runtime`: real
        bytes on a real socket, scored with the overlap hidden-fraction
        folded in (a config whose wire hides behind compute tunes better
        than one that stalls the chunk, at equal round time)."""
        import json
        import os
        import tempfile

        from repro_torch.device import resolve_device
        from repro_torch.fed.runtime import RuntimeArgs, run_pair
        from repro_torch.obs.report import hidden_fraction

        w = self.workload
        dev = resolve_device(self.device)
        transport = point.transport if point.transport in ("dense",
                                                           "topk") \
            else "dense"
        workers = point.workers or self.processes
        with tempfile.TemporaryDirectory() as td:
            trace_path = os.path.join(td, "trace.json")
            a = RuntimeArgs(clients=w.n_clients, m=w.m_per_client,
                            dim=w.dim, alpha=w.alpha, beta=w.beta,
                            data_seed=w.data_seed, lam=w.lam, x64=w.x64,
                            tau=w.tau, transport=transport,
                            ratio=point.ratio, plane=point.plane,
                            chunk=point.chunk_rounds, rounds=self.rounds,
                            workers=workers, mode=point.wire_mode,
                            trace=trace_path, device=str(dev))
            rep = run_pair(a)
            with open(trace_path) as f:
                doc = json.load(f)
        self.measured_trials += 1
        self.last_trace = doc
        registry = _metrics.MetricsRegistry()
        wall = float(rep.get("wall_s", 0.0))
        registry.gauge("tune/round_us").set(wall / self.rounds * 1e6)
        registry.gauge("tune/bytes_per_client_round").set(
            float(rep.get("bytes_sent", 0)) / self.rounds
            / max(1, w.n_clients))
        registry.gauge("tune/staleness_mean").set(0.0)
        registry.gauge("tune/hidden_fraction").set(hidden_fraction(doc))
        return self.score(point, registry.snapshot())

    # -- scoring ----------------------------------------------------------

    def score(self, point: TrialPoint, snapshot: dict) -> TrialResult:
        """Scalar objective from an obs snapshot (lower is better):

            round_us + bytes_weight * bytes/client/round
                     + staleness_weight * mean_age * round_us
                     - hidden_credit

        The bytes tax prices the uplink (default 0.05 us/byte, i.e. a
        dense 168 B client pays ~8 us vs ~1 us for 10% top-k), so equal
        times break toward fewer bytes but a genuinely faster dense config
        still wins.  Multi-process trials earn back up to 10% of round
        time proportional to the wire's hidden fraction.
        """
        g = snapshot.get("gauges", {})
        round_us = float(g.get("tune/round_us", 0.0))
        bytes_pcr = float(g.get("tune/bytes_per_client_round", 0.0))
        stale = float(g.get("tune/staleness_mean", 0.0))
        hidden = float(g.get("tune/hidden_fraction", 0.0))
        objective = (round_us + self.bytes_weight * bytes_pcr
                     + self.staleness_weight * stale * round_us
                     - 0.1 * hidden * round_us)
        return TrialResult(point=point, objective=objective,
                           round_us=round_us,
                           bytes_per_client_round=bytes_pcr,
                           staleness_mean=stale, rounds=self.rounds,
                           snapshot=snapshot)


def _sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
