"""Serving plane of the port: snapshot hot-swap and the batched decode
engine.

  * :mod:`repro_torch.serving.snapshot` -- the atomically swapped,
    versioned :class:`ServingSnapshot` plane (a copy of the reference's);
  * :mod:`repro_torch.serving.engine` -- prefill through the flash kernel,
    decode segments with one host sync each, continuous-batching request
    admission with per-slot cache lengths.

Not ported yet: :mod:`repro.serving.delta` (it needs ``comm/wire``) and the
round engine's snapshot sink.
"""
from repro_torch.serving.engine import (GenerationResult, Request,
                                        RequestResult, ServingEngine)
from repro_torch.serving.snapshot import ServingSnapshot, SnapshotStore

__all__ = ["ServingSnapshot", "SnapshotStore", "ServingEngine",
           "GenerationResult", "Request", "RequestResult"]
