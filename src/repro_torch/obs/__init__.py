"""repro_torch.obs: tracing, metrics and Perfetto export for the port.

Three parts, one package, stdlib only (no ``torch``):

  * `repro_torch.obs.trace`: contextvar-scoped runtime spans (`span`,
    `tracing`, `Stopwatch`) with a no-op fast path when disabled;
    instrumented into the planner, the plan and dataflow checks, the planner
    service, and the kernel pre-flight and launch (``kernel.preflight``,
    ``kernel.launch``). It is the port's one home for a host clock.
  * `repro_torch.obs.metrics`: the process-wide metric `REGISTRY`
    (counters, gauges, histograms) that holds the planner's cache
    statistics and the service's latency distribution; Prometheus text and
    a JSON snapshot.
  * `repro_torch.obs.export`: Chrome/Perfetto trace-event JSON from runtime
    spans (host time). The simulator timeline waits for ROADMAP A10.

CLI: ``python -m repro_torch.obs`` (metrics / trace-load / export). See the
README's "Observability in the port" for the span API and the metric names.
"""

from repro_torch.obs.export import (simreport_to_trace, spans_to_trace,
                                    trace_json, verify_sim_trace, write_trace)
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     Registry, StatsCounter, counter, gauge,
                                     histogram)
from repro_torch.obs.trace import (SpanRecord, Stopwatch, Tracer, disable,
                                   enable, enabled, get_tracer, span, tracing)

__all__ = [
    # trace
    "SpanRecord", "Tracer", "Stopwatch", "span", "enabled", "enable",
    "disable", "get_tracer", "tracing",
    # metrics
    "REGISTRY", "Registry", "Counter", "Gauge", "Histogram", "StatsCounter",
    "counter", "gauge", "histogram",
    # export
    "spans_to_trace", "simreport_to_trace", "trace_json", "write_trace",
    "verify_sim_trace",
]
