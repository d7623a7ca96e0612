"""Simulated asynchrony: virtual-time client clocks, a buffered
staleness-aware server aggregator, the staleness ledger, and cohort-resident
client state.

The counterpart of :mod:`repro.sched`, driven by the engine's Asynchrony
stage (``EngineConfig(clock=..., buffer_size=..., staleness=...,
queue_depth=..., edges=...)``) and Cohort stage (``population=``,
``cohort=``) in :mod:`repro_torch.exec`:

  * :mod:`repro_torch.sched.clock` -- deterministic, log-normal and
    straggler-mixture round durations from a draw source, optionally split
    into compute and upload streams;
  * :mod:`repro_torch.sched.aggregator` -- the FedBuff-style buffered
    commit (``buffer_size`` earliest reports), staleness weighting with an
    optional error-feedback correction, the one-slot :class:`AsyncState`
    buffer or the ``queue_depth``-deep :class:`QueueState`; in plane mode
    the commit's client-axis sum is one launch of the weighted-commit
    kernel;
  * :mod:`repro_torch.sched.cohort` -- :class:`CohortSpec`, the lazily
    materialized :class:`PopulationStore` (the reference's npz layout) and
    the :class:`ResidentCohort` gather/scatter at chunk boundaries;
  * :mod:`repro_torch.sched.arrivals` -- the real-time arrival ledger.

Zero-delay contract: ``DeterministicClock()`` + ``buffer_size=n_clients``
is the port's synchronous engine, bitwise.
"""
from repro_torch.sched.aggregator import (AGE_HIST_BUCKETS, AsyncState,
                                          QueueState, Staleness, as_staleness,
                                          init_async_state, init_queue_state,
                                          make_async_round)
from repro_torch.sched.arrivals import Arrival, ArrivalLedger
from repro_torch.sched.clock import (ClockModel, DeterministicClock,
                                     LogNormalClock, StragglerClock,
                                     clock_is_stochastic, get_clock)
from repro_torch.sched.cohort import (CohortSpec, PopulationStore,
                                      ResidentCohort, sched_client_axes)

__all__ = ["ClockModel", "DeterministicClock", "LogNormalClock",
           "StragglerClock", "get_clock", "clock_is_stochastic",
           "Staleness", "as_staleness", "AsyncState", "QueueState",
           "init_async_state", "init_queue_state", "make_async_round",
           "AGE_HIST_BUCKETS", "CohortSpec", "PopulationStore",
           "ResidentCohort", "sched_client_axes",
           "Arrival", "ArrivalLedger"]
