"""The communication layer of the round engine.

The counterpart of :mod:`repro.comm` without its wire codec (which comes
with the runtime slice): uplink compressors with error feedback
(:mod:`repro_torch.comm.transport`), the broadcast compressor
(:class:`DownlinkCompressor`), staleness-adaptive top-k
(:mod:`repro_torch.comm.schedule`), byte accounting, and the draw sources
that take the place of the reference's ``jax.random`` keys.
"""
from repro_torch.comm.transport import (GRANULARITIES, Dense,
                                        DownlinkCompressor, GeneratorDraws,
                                        PlaneTransport, Quantize, RandK,
                                        ReplayDraws, TopK, Transport,
                                        broadcast_elements, get_transport,
                                        message_elements_per_client,
                                        uplink_message_spec)
from repro_torch.comm.schedule import (SCHEDULE_KINDS, RatioSchedule,
                                       ScheduledTopK, as_schedule,
                                       scheduled_transport)

__all__ = ["Transport", "Dense", "TopK", "RandK", "Quantize",
           "DownlinkCompressor", "PlaneTransport", "GRANULARITIES",
           "RatioSchedule", "ScheduledTopK", "SCHEDULE_KINDS",
           "as_schedule", "scheduled_transport", "GeneratorDraws",
           "ReplayDraws", "get_transport", "message_elements_per_client",
           "uplink_message_spec", "broadcast_elements"]
