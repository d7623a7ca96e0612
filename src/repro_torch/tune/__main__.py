"""``python -m repro_torch.tune``: tune the synthetic workload on a device.

Trials run on ``--device`` (``cuda`` unless ``--device cpu``; without a
card the search raises).  ``--dry`` exercises the full search loop against
an analytic surrogate runner (no measurements) -- the smoke mode that makes
search/record regressions fail loudly in seconds.  ``--validate``
schema-checks existing record files and exits.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.tune.records import validate_record
from repro_torch.tune.runner import TrialRunner
from repro_torch.tune.search import tune
from repro_torch.tune.space import SearchSpace, TrialPoint, Workload


class _SurrogateRunner(TrialRunner):
    """Analytic stand-in for ``--dry``: scores points from a smooth model
    of the bench surface (chunking amortizes dispatch, compression trades
    bytes for selection time) without running an engine."""

    def __init__(self, workload: Workload, *, rounds: int = 64):
        super().__init__(workload, rounds=rounds)

    def measure(self, point: TrialPoint):
        from repro_torch.obs.metrics import MetricsRegistry

        self.measured_trials += 1
        dense_b = 8.0 * self.workload.dim + 8.0
        round_us = 400.0 + 1200.0 / point.chunk_rounds
        bytes_pcr = dense_b
        if point.transport != "dense":
            round_us += 30.0 + (15.0 if point.granularity == "leaf" else 5.0)
            bytes_pcr = max(1.0, point.ratio * dense_b)
        if point.queue_depth:
            round_us += 10.0
        if point.schedule != "constant":
            bytes_pcr *= 0.7
        registry = MetricsRegistry()
        registry.gauge("tune/round_us").set(round_us)
        registry.gauge("tune/bytes_per_client_round").set(bytes_pcr)
        registry.gauge("tune/staleness_mean").set(
            0.8 if self.workload.is_async else 0.0)
        return self.score(point, registry.snapshot())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="measured EngineConfig search with a persisted "
                    "per-device record cache")
    ap.add_argument("--budget", type=int, default=12,
                    help="measured-trial budget (default 12)")
    ap.add_argument("--rounds", type=int, default=64,
                    help="measured rounds per trial (default 64)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dry", action="store_true",
                    help="surrogate runner: exercise the search + record "
                         "plumbing without measuring")
    ap.add_argument("--cache-dir", default=None,
                    help="tuning-record directory (default "
                         "experiments/tune_torch)")
    ap.add_argument("--force", action="store_true",
                    help="ignore a cached record and re-measure")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="tune the straggler-clock async workload "
                         "(activates buffer/queue/staleness/schedule axes)")
    ap.add_argument("--processes", type=int, default=0,
                    help="measure trials across N worker processes "
                         "(repro_torch.fed.runtime) and fold the wire "
                         "hidden-fraction into the objective")
    ap.add_argument("--device", default=None,
                    help="device the trials run on (default cuda; cpu runs "
                         "them on the host)")
    ap.add_argument("--validate", nargs="+", metavar="RECORD.json",
                    help="schema-check record files and exit")
    args = ap.parse_args(argv)

    if args.validate:
        bad = 0
        for path in args.validate:
            with open(path) as f:
                errors = validate_record(json.load(f))
            if errors:
                bad += 1
                print(f"{path}: INVALID")
                for e in errors:
                    print(f"  - {e}")
            else:
                print(f"{path}: ok")
        return 1 if bad else 0

    workload = Workload(clock="straggler" if args.async_ else "none")
    runner = None
    space = None
    if args.dry:
        runner = _SurrogateRunner(workload, rounds=args.rounds)
    elif args.processes:
        runner = TrialRunner(workload, rounds=args.rounds,
                             processes=args.processes, device=args.device)
        # widen the space: worker count and wire mode become live axes,
        # so the search itself decides whether the wire pays for overlap
        space = SearchSpace(workers=(0, args.processes),
                            wire_mode=("blocking", "overlapped"))
    # --dry never touches the record cache: the surrogate's objective is
    # not comparable to measured records, so it neither hits nor saves
    record = tune(workload, space=space, budget=args.budget,
                  rounds=args.rounds,
                  seed=args.seed, runner=runner, cache_dir=args.cache_dir,
                  force=args.force or args.dry, save=not args.dry,
                  log=print, device=args.device)
    best = record["best"]
    point = TrialPoint.from_dict(best["point"])
    print(f"winner: {point.describe()}")
    print(f"  objective            {best['objective']:.1f}")
    print(f"  us/round             {best['round_us']:.1f}")
    print(f"  bytes/client/round   {best['bytes_per_client_round']:.0f}")
    print(f"  measured trials      {record['measured_trials']}"
          f"{' (cache hit)' if record.get('cached') else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
