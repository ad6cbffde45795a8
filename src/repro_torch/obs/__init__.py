"""Observability: span tracing with Chrome-trace export and stage
annotation (``trace``), and the counter/gauge/histogram registry whose
``snapshot()`` the serve report composes (``metrics``)."""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import (NULL_TRACER, Tracer, annotate,
                                   validate_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_TRACER",
    "Tracer", "annotate", "validate_chrome_trace",
]
