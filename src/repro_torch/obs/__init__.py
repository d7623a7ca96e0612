"""Observability of the port: numpy-only copies of the reference's
:mod:`repro.obs` -- the ring-buffer span tracer with its cross-process
Chrome trace-event merge (:mod:`repro_torch.obs.trace`), the
counter/gauge/histogram registry with its JSONL sink
(:mod:`repro_torch.obs.metrics`) and the overlap attribution of a merged
trace (:mod:`repro_torch.obs.report`)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, JsonlSink,
                                     MetricsRegistry)
from repro_torch.obs.trace import (NULL_TRACER, Tracer, install, span, timed,
                                   uninstall)

__all__ = ["Counter", "Gauge", "Histogram", "JsonlSink", "MetricsRegistry",
           "NULL_TRACER", "Tracer", "install", "span", "timed", "uninstall"]
