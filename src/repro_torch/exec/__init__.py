"""The round-execution engine, its stages and its batch suppliers.

The counterpart of :mod:`repro.exec` without placement: chunked rounds with
one host sync per chunk, partial participation, compressed uplinks and
downlinks (optionally on the flat plane), simulated asynchrony (buffered
staleness-weighted commits), cohort-resident client state, chunk-aware
suppliers (with prefetch), and the literal per-client protocol form
(``EngineConfig(protocol=True)``).

    from repro_torch.exec import ArraySupplier, EngineConfig, RoundEngine

    eng = RoundEngine(alg, grad_fn, n_clients, EngineConfig(chunk_rounds=16))
    state = eng.init(params0)
    supplier = ArraySupplier.from_dataset(data, tau, None, device_cache=True)
    state, metrics = eng.run(state, supplier, rounds=100, rng=rng)

    # global top-k 25% of the uplink, on the flat plane
    eng = RoundEngine(alg, grad_fn, n_clients, EngineConfig(
        plane=True, transport=TopK(0.25, granularity="global")))

    # stragglers 4x slower, commit at 15 of 30 reports, staleness-corrected
    eng = RoundEngine(alg, grad_fn, 30, EngineConfig(
        clock=StragglerClock(slowdown=4.0), buffer_size=15,
        staleness=Staleness("poly", correct=True)))
"""
from repro_torch.exec.engine import (EngineConfig, RoundEngine,
                                     rounds_to_boundary, sample_active_masks,
                                     server_state_fields)
from repro_torch.exec.stages import (Asynchrony, Cohort, DownlinkComm,
                                     StageStack, UplinkComm)
from repro_torch.exec.suppliers import (ArraySupplier, BatchSupplier,
                                        CallableSupplier, as_supplier,
                                        supports_client_ids)

__all__ = ["EngineConfig", "RoundEngine", "rounds_to_boundary",
           "sample_active_masks", "server_state_fields", "StageStack",
           "UplinkComm", "DownlinkComm", "Asynchrony", "Cohort",
           "ArraySupplier", "BatchSupplier", "CallableSupplier",
           "as_supplier", "supports_client_ids"]
