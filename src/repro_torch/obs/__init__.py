"""Observability: spans for the host trace, the profiler and NVTX with
Chrome-trace export (``trace``), and the counter/gauge/histogram registry
whose ``snapshot()`` the serve report composes, with the process-wide
kernel-launch counters (``metrics``)."""
from repro_torch.obs.metrics import (PROCESS_METRICS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     kernel_launches)
from repro_torch.obs.trace import (PROCESS_TRACER, Tracer, annotate,
                                   merge_chrome_traces,
                                   validate_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "PROCESS_METRICS",
    "PROCESS_TRACER", "Tracer", "annotate", "kernel_launches",
    "merge_chrome_traces", "validate_chrome_trace",
]
