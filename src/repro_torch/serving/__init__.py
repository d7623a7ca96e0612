"""Serving plane of the port: snapshot hot-swap and the batched decode
engine.

  * :mod:`repro_torch.serving.snapshot` -- the atomically swapped,
    versioned :class:`ServingSnapshot` plane (a copy of the reference's);
  * :mod:`repro_torch.serving.engine` -- prefill through the flash kernel,
    decode segments with one host sync each, continuous-batching request
    admission with per-slot cache lengths;
  * :mod:`repro_torch.serving.delta` -- bitwise XOR-delta publication of
    snapshots to replicas (the T_SNAP frames of the runtime).
"""
from repro_torch.serving.delta import (DeltaPublisher, DeltaReplica,
                                       SnapshotGap, apply_delta, tree_digest,
                                       xor_delta)
from repro_torch.serving.engine import (GenerationResult, Request,
                                        RequestResult, ServingEngine)
from repro_torch.serving.snapshot import ServingSnapshot, SnapshotStore

__all__ = ["ServingSnapshot", "SnapshotStore", "ServingEngine",
           "GenerationResult", "Request", "RequestResult", "DeltaPublisher",
           "DeltaReplica", "SnapshotGap", "xor_delta", "apply_delta",
           "tree_digest"]
