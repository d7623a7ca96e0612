"""End-to-end federated LM training: the port of
:mod:`repro.launch.train`.

Trains a ported architecture (the reduced "smoke" scale by default, or a
~100M-parameter member of its family) with Algorithm 1 or a baseline over
heterogeneous per-client token streams, through the round engine
(:mod:`repro_torch.exec`), with checkpointing.  Every engine flag of the
reference stacks with every other: ``--chunk``, ``--participation``,
``--transport`` / ``--compress-ratio`` / ``--ratio-schedule`` /
``--granularity`` / ``--plane``, ``--downlink``, the async flags
(``--async``, ``--clock``, ``--buffer-size``, ``--staleness``,
``--staleness-correct``, ``--queue-depth``, ``--upload``, ``--edges``),
``--population`` / ``--cohort``, ``--device-cache``, ``--prefetch``,
``--trace``, ``--metrics-jsonl`` and ``--publish-snapshots``.

It runs on the card unless ``--device cpu`` is given; on the card the
transformer's attention runs the flash kernels forward and backward and
DProx's local step the fused update kernel.  ``--autotune BUDGET`` first
searches the engine configuration on the same device
(:func:`repro_torch.tune.tune`, the synthetic logreg workload, cache-first)
and adopts the winner's chunk, plane, transport, ratio, granularity and
ratio schedule -- under asynchrony also its buffer, queue depth and
staleness weighting.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_1_6b \\
        --scale smoke --rounds 50 --tau 4 --clients 4 --ckpt out/ck.npz
    PYTHONPATH=src python -m repro_torch.launch.train --scale 100m \\
        --rounds 4 --tau 2 --clients 2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --rounds 2 --tau 2 --clients 2 --batch 2 --seq 16

``--processes N`` hands over to the multi-process runtime
(:func:`repro_torch.fed.runtime.main`, its own flag set), as the reference
does.

:func:`build` is the set-up (config, params, data, algorithm, engine,
supplier) that :func:`main` runs through :func:`train`; ``chip_smoke.py``
calls the same two for its full-width run.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.core.algorithm import DProxConfig
from repro_torch.core.baselines import FedAvg, FedDA, FedMid, Scaffold
from repro_torch.core.prox import L1
from repro_torch.data.synthetic import token_stream_heterogeneous
from repro_torch.device import resolve_device
from repro_torch.exec import (ArraySupplier, EngineConfig, RoundEngine,
                              rounds_to_boundary)
from repro_torch.fed.simulator import DProxAlgorithm
from repro_torch.models import transformer as T
from repro_torch.models.layers import AttnCfg
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def scale_config(cfg, scale: str):
    if scale == "smoke":
        return cfg
    if scale == "100m":
        # ~100M-parameter member of the same family (its GQA group kept)
        attn = cfg.attn
        if attn is not None:
            group = max(attn.num_heads // attn.num_kv_heads, 1)
            attn = AttnCfg(kind=attn.kind, num_heads=12,
                           num_kv_heads=max(12 // group, 1), head_dim=64,
                           rope_theta=attn.rope_theta,
                           logit_softcap=attn.logit_softcap,
                           causal=attn.causal)
        return cfg.with_overrides(
            name=cfg.name + "-100m", n_layers=8, d_model=768, d_ff=2048,
            vocab=32768, attn=attn, remat=False)
    raise ValueError(scale)


def make_algorithm(name, reg, tau, eta, eta_g):
    if name == "dprox":
        return DProxAlgorithm(reg, DProxConfig(tau=tau, eta=eta, eta_g=eta_g))
    if name == "fedda":
        return FedDA(reg, tau, eta, eta_g)
    if name == "fedmid":
        return FedMid(reg, tau, eta, eta_g)
    if name == "fedavg":
        return FedAvg(tau, eta, eta_g)
    if name == "scaffold":
        return Scaffold(reg, tau, eta, eta_g)
    raise ValueError(name)


def main_multiprocess(argv):
    """``--processes N``: the multi-process runtime's entry point (a server
    process and N workers, rank 0 in this process)."""
    from repro_torch.fed import runtime

    ap = argparse.ArgumentParser(
        description="multi-process federated training "
                    "(repro_torch.fed.runtime flags)")
    ap.add_argument("--processes", type=int, required=True,
                    help="number of worker processes (+1 server process)")
    ap.add_argument("--check-parity", action="store_true",
                    help="(1 worker) also run single-process and assert "
                         "the server trajectory matches bitwise")
    runtime.add_runtime_args(ap)
    ns = ap.parse_args(argv)
    if ns.processes < 1:
        ap.error("--processes must be >= 1")
    ns.workers = ns.processes
    run_argv = (["--role", "pair"]
                + (["--check-parity"] if ns.check_parity else [])
                + runtime._to_argv(runtime._from_ns(ns)))
    return runtime.main(run_argv)


def parser() -> argparse.ArgumentParser:
    """The single-process flags: the reference's, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1_6b")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--algorithm", default="dprox")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4, help="per-client batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eta", type=float, default=2e-2)
    ap.add_argument("--eta-g", type=float, default=2.0)
    ap.add_argument("--lam", type=float, default=1e-6, help="L1 strength")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=4,
                    help="rounds run between two host syncs of the metrics")
    ap.add_argument("--participation", type=float, default=None,
                    help="fraction of clients active per round (dprox only)")
    ap.add_argument("--transport", default=None,
                    choices=["dense", "topk", "randk", "quantize"],
                    help="compress uplinks through this repro_torch.comm "
                         "transport")
    ap.add_argument("--compress-ratio", type=float, default=0.1,
                    help="kept-coordinate fraction for topk/randk")
    ap.add_argument("--ratio-schedule", default="constant",
                    choices=["constant", "linear", "bucketed"],
                    help="staleness-adaptive per-commit ratio schedule for "
                         "--transport topk (repro_torch.comm.schedule); "
                         "constant is the fixed-ratio transport")
    ap.add_argument("--autotune", type=int, default=None, metavar="BUDGET",
                    help="tune the engine config on --device with "
                         "repro_torch.tune (BUDGET measured trials, "
                         "cache-first) and adopt the winner")
    ap.add_argument("--downlink", default=None,
                    choices=["dense", "topk", "randk", "quantize"],
                    help="compress the broadcast direction too "
                         "(DownlinkComm stage; shares --compress-ratio)")
    ap.add_argument("--granularity", default="leaf",
                    choices=["leaf", "global"],
                    help="compress per pytree leaf or the whole flat "
                         "d-vector")
    ap.add_argument("--plane", action="store_true",
                    help="carry the stage state as flat (clients, d_pad) "
                         "parameter planes (repro_torch.core.plane)")
    ap.add_argument("--device-cache", action="store_true",
                    help="keep the token streams on the device (batches "
                         "are gathered there)")
    ap.add_argument("--prefetch", action="store_true",
                    help="stage the next chunk's batches while the current "
                         "chunk computes")
    ap.add_argument("--async", dest="run_async", action="store_true",
                    help="simulated asynchrony with the default straggler "
                         "clock (any async flag below also activates it)")
    ap.add_argument("--clock", default=None,
                    choices=["deterministic", "lognormal", "straggler"],
                    help="async: virtual-time clock model "
                         "(default: straggler)")
    ap.add_argument("--buffer-size", type=int, default=None,
                    help="async: reports the server waits for per commit "
                         "(default: all clients)")
    ap.add_argument("--staleness", default=None,
                    choices=["uniform", "poly"],
                    help="async: stale-report weighting (default: uniform)")
    ap.add_argument("--staleness-correct", action="store_true",
                    help="async: keep the downweighted stale mass in a "
                         "server-side error-feedback residual")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="async: per-client in-flight report queue depth")
    ap.add_argument("--upload", type=float, default=None,
                    help="async: constant per-report upload time, split "
                         "from the clock's compute stream")
    ap.add_argument("--edges", type=int, default=None,
                    help="async: aggregate commits through a client->edge"
                         "->root tree with this many edge servers")
    ap.add_argument("--population", type=int, default=None,
                    help="cohort: total simulated client population "
                         "(default: --clients)")
    ap.add_argument("--cohort", type=int, default=None,
                    help="cohort: resident working-set width (default: the "
                         "full population)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record engine/supplier spans and write a Chrome "
                         "trace-event JSON here")
    ap.add_argument("--metrics-jsonl", default=None, metavar="OUT.jsonl",
                    help="append one JSONL line per round plus a final "
                         "metrics-registry snapshot")
    ap.add_argument("--publish-snapshots", action="store_true",
                    help="publish the committed global model into a "
                         "repro_torch.serving.SnapshotStore after every "
                         "chunk")
    ap.add_argument("--device", default=None,
                    help="device to train on (default cuda; cpu runs on "
                         "the host)")
    return ap


@dataclasses.dataclass
class Run:
    """What :func:`build` sets up and :func:`train` runs."""

    args: argparse.Namespace
    cfg: Any
    n_params: int
    engine: RoundEngine
    state: Any
    supplier: Any
    population: int
    run_async: bool
    clock: Any = None
    snapshots: Any = None
    close: Any = None  # ends the supplier's staging thread


def _comm(args):
    """(uplink, downlink) transports from the flags, or None each."""
    if args.transport is None and args.downlink is None:
        return None, None
    from repro_torch.comm import as_schedule, get_transport

    def make(name, uplink=False):
        # the schedule is an uplink policy (it reads the async age ledger);
        # the broadcast direction has no age signal
        if uplink and name == "topk" and args.ratio_schedule != "constant":
            return get_transport(
                "topk_sched",
                schedule=as_schedule(args.ratio_schedule,
                                     args.compress_ratio),
                granularity=args.granularity)
        kw = ({"ratio": args.compress_ratio}
              if name in ("topk", "randk") else {})
        if name != "dense":
            kw["granularity"] = args.granularity
        return get_transport(name, **kw)

    return (make(args.transport, uplink=True) if args.transport else None,
            make(args.downlink) if args.downlink else None)


def autotune(args: argparse.Namespace, run_async: bool, device) -> None:
    """``--autotune BUDGET``: tune the engine on ``device`` (or recall a
    record) and set the engine flags of ``args`` to the winning point."""
    from repro_torch.tune import TrialPoint, Workload, tune

    record = tune(Workload(clock="straggler" if run_async else "none"),
                  budget=args.autotune, log=print, device=device)
    point = TrialPoint.from_dict(record["best"]["point"])
    print(f"autotune: adopting {point.describe()} "
          f"({record['measured_trials']} measured trials"
          f"{', cached' if record.get('cached') else ''})")
    args.chunk = point.chunk_rounds
    args.plane = point.plane
    args.transport = (None if point.transport == "dense"
                      else point.transport)
    args.compress_ratio = point.ratio
    args.granularity = point.granularity
    args.ratio_schedule = point.schedule
    if run_async:
        args.buffer_size = max(1, int(round(point.buffer_frac
                                            * args.clients)))
        args.queue_depth = point.queue_depth or None
        args.staleness = point.staleness


def build(args: argparse.Namespace, *, cfg=None, params=None) -> Run:
    """The trainer's set-up from parsed flags: the config (``cfg`` if
    given, else ``--arch`` / ``--scale``, float32 params), the params
    (``params`` if given, else drawn on the CPU from ``--seed``, so the
    card and the CPU start from the same model, then moved), the token
    streams, the algorithm, the engine on ``--device`` and its supplier."""
    device = resolve_device(args.device)
    if cfg is None:
        base = (registry.get_smoke(args.arch) if args.scale == "smoke"
                else registry.get(args.arch))
        cfg = scale_config(base, args.scale).with_overrides(
            param_dtype=torch.float32)
    if params is None:
        params = T.init_model(torch.Generator().manual_seed(args.seed), cfg)
    n_params = T.count_params(params)

    # heterogeneous per-client bigram corpora (data/synthetic.py)
    streams = token_stream_heterogeneous(
        args.clients, args.seq, n_seqs_per_client=64,
        vocab=min(cfg.vocab, 512), seed=args.seed)
    alg = make_algorithm(args.algorithm, L1(lam=args.lam), args.tau,
                         args.eta, args.eta_g)
    # any async flag activates the asynchrony stage; --async alone picks
    # the straggler clock
    run_async = (args.run_async or args.clock is not None
                 or args.buffer_size is not None
                 or args.staleness is not None or args.staleness_correct
                 or args.queue_depth is not None or args.upload is not None
                 or args.edges is not None)
    if args.autotune:
        autotune(args, run_async, device)
    transport, downlink = _comm(args)
    clock = staleness = None
    if run_async:
        from repro_torch.sched import Staleness, get_clock

        clock = get_clock(args.clock or "straggler",
                          **({"upload": args.upload}
                             if args.upload is not None else {}))
        staleness = Staleness(args.staleness or "uniform",
                              correct=args.staleness_correct)
    population = (args.population if args.population is not None
                  else args.clients)
    engine = RoundEngine(
        alg, T.make_grad_fn(cfg), population,
        EngineConfig(chunk_rounds=args.chunk,
                     participation=args.participation, transport=transport,
                     downlink=downlink, clock=clock,
                     buffer_size=args.buffer_size, staleness=staleness,
                     queue_depth=args.queue_depth, plane=args.plane,
                     edges=args.edges, population=args.population,
                     cohort=args.cohort),
        device=device)
    snapshots = None
    if args.publish_snapshots:
        from repro_torch.serving import SnapshotStore

        snapshots = SnapshotStore()
        engine.set_snapshot_sink(
            snapshots.engine_sink(select=engine.global_params))
    state = engine.init(params)
    del params

    # chunk-aware supplier over the token streams: the whole chunk is
    # gathered in one vectorized call (on the device with --device-cache)
    inner = ArraySupplier(
        {"tokens": streams.astype(np.int32)}, args.tau, args.batch,
        seed=args.seed, device_cache=args.device_cache,
        prefetch=args.prefetch, device=device)
    supplier = inner
    if population != args.clients:
        # simulated population >> data streams: global client g trains on
        # stream g mod --clients, so batch assembly only ever touches the
        # resident cohort's rows
        def supplier(r, rng, *, client_ids=None):
            ids = (np.arange(population) if client_ids is None
                   else np.asarray(client_ids))
            return inner.sample_round(r, rng,
                                      client_ids=ids % args.clients)

    return Run(args=args, cfg=cfg, n_params=n_params, engine=engine,
               state=state, supplier=supplier, population=population,
               run_async=run_async, clock=clock, snapshots=snapshots,
               close=inner.close)


def train(run: Run, log=print):
    """Run ``--rounds`` rounds of ``run`` in engine segments aligned to the
    checkpoint cadence, logging and checkpointing as the reference does;
    returns ``(state, metrics)``, metrics over every round."""
    args, engine = run.args, run.engine
    tracer = obs_trace.install("train") if args.trace else None
    mreg = obs_metrics.MetricsRegistry()
    sink = (obs_metrics.JsonlSink(args.metrics_jsonl)
            if args.metrics_jsonl else None)
    t0 = obs_trace.now()

    def log_cb(ri, info):
        # fires per round after each chunk's host sync
        if sink is not None:
            sink.write("round", round=int(ri),
                       **{k: float(v) for k, v in info.items()
                          if np.ndim(v) == 0})
        if ri % args.log_every == 0 or ri == args.rounds - 1:
            log(f"round {ri:5d}  loss {info.get('train_loss', np.nan):.4f}  "
                f"({(obs_trace.now() - t0) / (ri + 1):.2f}s/round)")

    rng = np.random.default_rng(args.seed)
    ckpt_every = (args.ckpt_every if args.ckpt and args.ckpt_every > 0
                  else args.rounds)
    state, history, metrics = run.state, {}, {}
    try:
        r = 0
        while r < args.rounds:
            # align engine segments to the checkpoint cadence
            k = rounds_to_boundary(r, ckpt_every, args.rounds)
            state, metrics = engine.run(state, run.supplier, k, rng=rng,
                                        start_round=r, metrics_cb=log_cb)
            for key, vals in metrics.items():
                history.setdefault(key, []).extend(vals)
            r += k
            if args.ckpt and (r % ckpt_every == 0 or r == args.rounds):
                ckpt.save(state, args.ckpt,
                          metadata={"round": r, "arch": run.cfg.name,
                                    "algorithm": args.algorithm})
                if engine.population_store is not None:
                    # run() flushed the resident cohort at the segment end,
                    # so the store's rows are current
                    engine.population_store.save(
                        args.ckpt + ".store.npz", metadata={"round": r})
    finally:
        run.close()
    run.state = state
    _summary(run, metrics, history, log)
    wall = obs_trace.now() - t0
    if sink is not None:
        last = history.get("train_loss", [float("nan")])[-1]
        mreg.gauge("round_throughput").set(args.rounds / max(wall, 1e-9))
        mreg.counter("rounds").add(args.rounds)
        if engine.uplink_bytes_per_client_round is not None:
            mreg.counter("uplink/bytes").add(
                engine.uplink_bytes_per_client_round * args.clients
                * args.rounds)
        sink.write_snapshot(mreg, rounds=int(args.rounds),
                            final_loss=float(last))
        sink.close()
        log(f"metrics -> {args.metrics_jsonl}")
    if tracer is not None:
        obs_trace.write_chrome(
            obs_trace.to_chrome([tracer.export_wire(device=True)]),
            args.trace)
        obs_trace.uninstall()
        log(f"trace -> {args.trace} ({tracer.n_spans} spans; open in "
            "Perfetto)")
    return state, history


def _summary(run: Run, metrics: dict, history: dict, log) -> None:
    from repro_torch.core.metrics import sparsity

    args, engine = run.args, run.engine
    final = engine.global_params(run.state)
    if args.ckpt:
        log(f"checkpoint -> {args.ckpt}"
            + (f" (+ {args.ckpt}.store.npz)"
               if engine.population_store is not None else ""))
    last_loss = history.get("train_loss", [float("nan")])[-1]
    log(f"done: final loss {last_loss:.4f}, "
        f"global-model sparsity {float(sparsity(final)):.3f}")
    if run.snapshots is not None:
        snap = run.snapshots.latest()
        log(f"snapshots: {run.snapshots.version} published, latest "
            f"v{snap.version} (round {snap.round}, {snap.age():.2f}s old)")
    if engine.population_store is not None:
        st = engine.population_store
        log(f"cohort: {engine.n_clients}/{run.population} clients resident, "
            f"store {st.touched} touched rows ({st.nbytes / 1e6:.2f} MB "
            "host)")
    if run.run_async and metrics.get("vtime"):
        sm = metrics.get("staleness_mean", [0.0])
        depth = f" queue={engine.queue_depth}" if engine.queue_depth else ""
        log(f"async: clock={run.clock.name} buffer={engine.buffer_size}/"
            f"{args.clients}{depth}, virtual time {metrics['vtime'][-1]:.1f}, "
            f"mean report age (last segment) {np.mean(sm):.2f} rounds")
    if engine.uplink_bytes_per_client_round is not None:
        dense = run.n_params * 4
        log(f"uplink: {engine.uplink_bytes_per_client_round / 1e6:.2f} "
            f"MB/client/round ({engine.transport.name}; dense would be "
            f"{dense / 1e6:.2f} MB)")
    if engine.downlink_bytes_per_client_round is not None:
        log(f"downlink: {engine.downlink_bytes_per_client_round / 1e6:.2f} "
            f"MB/client/round ({engine.downlink.transport.name})")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if any(s == "--processes" or s.startswith("--processes=")
           for s in argv):
        return main_multiprocess(argv)
    args = parser().parse_args(argv)
    run = build(args)
    print(f"arch={run.cfg.name} params={run.n_params:,} "
          f"clients={args.clients} tau={args.tau} alg={args.algorithm} "
          f"device={run.engine.device}", flush=True)
    state, _ = train(run, log=lambda m: print(m, flush=True))
    return state


if __name__ == "__main__":
    main()
