"""The bare round-execution engine and its batch suppliers.

The counterpart of :mod:`repro.exec` without stages: chunked rounds with one
host sync per chunk, partial participation, chunk-aware suppliers.

    from repro_torch.exec import ArraySupplier, EngineConfig, RoundEngine

    eng = RoundEngine(alg, grad_fn, n_clients, EngineConfig(chunk_rounds=16))
    state = eng.init(params0)
    supplier = ArraySupplier.from_dataset(data, tau, None, device_cache=True)
    state, metrics = eng.run(state, supplier, rounds=100, rng=rng)
"""
from repro_torch.exec.engine import (EngineConfig, RoundEngine,
                                     rounds_to_boundary, sample_active_masks)
from repro_torch.exec.suppliers import (ArraySupplier, BatchSupplier,
                                        CallableSupplier, as_supplier)

__all__ = ["EngineConfig", "RoundEngine", "rounds_to_boundary",
           "sample_active_masks", "ArraySupplier", "BatchSupplier",
           "CallableSupplier", "as_supplier"]
