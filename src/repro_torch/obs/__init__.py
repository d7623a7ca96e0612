"""Observability of the port: numpy-only copies of the reference's
:mod:`repro.obs.metrics` registry and of the span-recording part of
:mod:`repro.obs.trace`."""
from repro_torch.obs.metrics import Counter, Histogram, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer, install, span

__all__ = ["Counter", "Histogram", "MetricsRegistry", "NULL_TRACER",
           "Tracer", "install", "span"]
