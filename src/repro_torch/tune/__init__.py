"""Closed-loop autotuning of the round engine: the port of
:mod:`repro.tune`.

The engine's configuration space (chunk size x transport x ratio x
granularity x buffer size x queue depth x staleness x plane) is large
enough that the best ``EngineConfig`` depends on the device and the
workload.  This package closes the loop on the device the trials run on
(``cuda`` unless the caller passes ``device="cpu"``):

  * :mod:`~repro_torch.tune.space`   -- the typed search space: canonical
    :class:`TrialPoint` coordinates over a :class:`SearchSpace`, plus the
    one mapping from a point to ``EngineConfig`` kwargs;
  * :mod:`~repro_torch.tune.runner`  -- measured trials scored from
    :mod:`repro_torch.obs` instruments (trace-span round time, measured
    uplink bytes, arrival-age staleness, multi-process hidden fraction);
  * :mod:`~repro_torch.tune.search`  -- the budgeted explore -> halve ->
    hillclimb search, cache-first;
  * :mod:`~repro_torch.tune.records` -- persisted tuning records (JSON
    keyed by device x workload x space signature, provenance-stamped) so a
    second invocation reuses measured trials instead of re-running them.

  * :mod:`~repro_torch.tune.pairs`   -- the roofline hillclimb over the
    model-scale (arch x shape) pairs, measured by the dry run
    (:mod:`repro_torch.launch.dryrun`) instead of wall-clock trials.

CLI::

    PYTHONPATH=src python -m repro_torch.tune --budget 12
    PYTHONPATH=src python -m repro_torch.tune --device cpu --budget 3 --dry
    PYTHONPATH=src python -m repro_torch.tune --validate \\
        experiments/tune_torch/*.json
"""
from repro_torch.tune.records import (SCHEMA, host_signature, load_record,
                                      record_key, record_path, save_record,
                                      validate_record)
from repro_torch.tune.runner import TrialResult, TrialRunner
from repro_torch.tune.search import tune
from repro_torch.tune.space import (SearchSpace, TrialPoint, Workload,
                                    engine_config_kwargs)

__all__ = [
    "Workload", "TrialPoint", "SearchSpace", "engine_config_kwargs",
    "TrialRunner", "TrialResult", "tune",
    "SCHEMA", "host_signature", "record_key", "record_path",
    "save_record", "load_record", "validate_record",
]
