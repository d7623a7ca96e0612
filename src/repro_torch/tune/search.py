"""The closed-loop search: explore -> halve -> hillclimb, cache-first.

The port of :mod:`repro.tune.search`, a budgeted search over
:class:`~repro_torch.tune.space.SearchSpace`:

  1. **explore** -- the default point plus seeded samples, measured at the
     trial length (successive halving's wide rung);
  2. **halve**   -- the top half re-measured with a longer run (the narrow
     rung: noise shrinks where it matters);
  3. **hillclimb** -- seeded single-axis mutations of the incumbent,
     accepted on improvement.

``budget`` counts *measured trials* (a halving re-measure costs one), and
every proposal draws from one ``np.random.default_rng(seed)`` stream, so
the trial sequence -- and therefore the record -- is a pure function of
``(seed, budget, space, workload)`` and the measured objectives.

A search first consults the persisted record cache
(:mod:`repro_torch.tune.records`): on a hit for the same
device/workload/space signatures it returns the stored result with
**zero** measured trials.  ``force=True`` re-measures and overwrites.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.tune import records as _records
from repro_torch.tune.runner import TrialResult, TrialRunner
from repro_torch.tune.space import SearchSpace, TrialPoint, Workload


def tune(workload: Optional[Workload] = None, *,
         space: Optional[SearchSpace] = None, budget: int = 12,
         rounds: int = 64, seed: int = 0, runner: Optional[TrialRunner]
         = None, cache_dir: Optional[str] = None, force: bool = False,
         save: bool = True, log=None, device=None) -> dict:
    """Run (or recall) a tuning search; returns the record dict.

    The record's ``best["point"]`` is the winning TrialPoint (as a dict --
    ``TrialPoint.from_dict`` it), ``record["measured_trials"]`` is how
    many trials this call actually executed (0 = pure cache hit), and
    ``record["cached"]`` says which path was taken.

    ``device`` is where the trials run (``cuda`` unless given; it raises
    without a card): it keys the record and goes to the :class:`TrialRunner`
    built when ``runner`` is omitted.  ``runner`` is injectable (tests pass
    an analytic fake).  ``log`` is a ``print``-like callable for progress
    lines (None = silent).
    """
    workload = workload or Workload()
    space = space or SearchSpace()
    space.validate()
    say = log or (lambda *a: None)

    host = _records.host_signature(device, x64=workload.x64)
    key = _records.record_key(host, workload.signature(),
                              space.signature())
    if not force:
        hit = _records.load_record(key, cache_dir, host=host,
                                   workload_sig=workload.signature(),
                                   space_sig=space.signature())
        if hit is not None:
            hit["cached"] = True
            hit["measured_trials"] = 0
            say(f"tune: cache hit {key[:16]} "
                f"(best {hit['best']['point']}, 0 measured trials)")
            return hit

    runner = runner or TrialRunner(workload, rounds=rounds, device=device)
    rng = np.random.default_rng(seed)
    budget = max(1, int(budget))
    results: dict[str, TrialResult] = {}  # point.key() -> best result
    trials: list[TrialResult] = []        # every measured trial, in order
    spent = 0

    def measure(point: TrialPoint, *, stretch: int = 1) -> TrialResult:
        nonlocal spent
        base_rounds = runner.rounds
        runner.rounds = base_rounds * stretch
        try:
            res = runner.measure(point)
        finally:
            runner.rounds = base_rounds
        spent += 1
        trials.append(res)
        prev = results.get(point.key())
        if prev is None or res.objective < prev.objective:
            results[point.key()] = res
        say(f"tune: [{spent}/{budget}] {point.describe():<40} "
            f"obj={res.objective:.1f} us/round={res.round_us:.1f} "
            f"B/client={res.bytes_per_client_round:.0f}")
        return res

    def best() -> TrialResult:
        return min(results.values(), key=lambda r: r.objective)

    # -- 1. explore: the wide rung ---------------------------------------
    n_explore = max(1, min(budget, (budget + 1) // 2))
    for p in space.initial_candidates(n_explore, rng, workload):
        if spent >= budget:
            break
        measure(p)

    # -- 2. halve: re-measure the top half, 2x the rounds ----------------
    if spent < budget and len(results) > 1:
        ranked = sorted(results.values(), key=lambda r: r.objective)
        for r in ranked[:max(1, len(ranked) // 2)]:
            if spent >= budget:
                break
            measure(r.point, stretch=2)

    # -- 3. hillclimb: single-axis mutations of the incumbent ------------
    while spent < budget:
        incumbent = best()
        moved = False
        for q in space.neighbors(incumbent.point, rng, workload):
            if q.key() in results:
                continue
            measure(q)
            moved = True
            break
        if not moved:  # neighborhood exhausted within the dedup horizon
            break

    win = best()
    record = {
        "key": key, "host": host, "workload": workload.signature(),
        "space": space.signature(), "budget": budget, "rounds": rounds,
        "seed": seed, "cached": False, "measured_trials": spent,
        "best": win.to_dict(),
        "trials": [t.to_dict() for t in trials],
    }
    if save:
        path = _records.save_record(record, cache_dir)
        record["path"] = path
        say(f"tune: saved record {path}")
    say(f"tune: best {win.point.describe()} obj={win.objective:.1f} "
        f"({spent} measured trials)")
    return record
