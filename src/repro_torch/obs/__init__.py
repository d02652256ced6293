"""repro_torch.obs — the tracing and metrics spine of the serving path (the
twin of ``repro.obs``, copied, not imported: the port imports nothing of the
reference package).

* :mod:`repro_torch.obs.registry` — label-keyed counters, gauges and
  histograms with p50/p90/p99, lock-safe, snapshot to a dict. The router's
  ``RouterMetrics``, the stores' ``CacheStats``, the LSH index's
  ``LSHTelemetry`` and the device bank's upload counters are views over one
  :class:`MetricsRegistry`.
* :mod:`repro_torch.obs.spans` — structured spans (``trace_span`` context
  manager, and ``start_span``/``end`` for work on pool threads) from the
  router through the distributed lookup and the match stages down to the
  index and the engines, with per-request cache-attribution events
  (:mod:`repro_torch.obs.attribution`). Exporters
  (:mod:`repro_torch.obs.exporters`): canonical JSONL and the Chrome trace
  format.

The names of spans, events and metrics are the reference's
(:mod:`repro_torch.obs.names` is a verbatim copy), so ``tools/check_trace.py``
checks the port's traces against the reference's catalog. The clock is
injectable. ``python -m repro_torch.obs`` runs a traced quickstart of the
serving path.
"""

from repro_torch.obs.attribution import (
    AttributionCollector,
    collect,
    deposit,
    tokens_saved_estimate,
)
from repro_torch.obs.exporters import (
    InMemoryExporter,
    JsonlExporter,
    chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    latency_buckets,
    pow2_buckets,
)
from repro_torch.obs.spans import (
    NOOP_SPAN,
    NOOP_TRACER,
    NoopTracer,
    Span,
    Tracer,
    current_span,
    get_tracer,
    set_tracer,
    trace_span,
    use_tracer,
)

__all__ = [
    "AttributionCollector",
    "Counter",
    "Gauge",
    "Histogram",
    "InMemoryExporter",
    "JsonlExporter",
    "MetricsRegistry",
    "NOOP_SPAN",
    "NOOP_TRACER",
    "NoopTracer",
    "Span",
    "Tracer",
    "chrome_trace",
    "collect",
    "current_span",
    "deposit",
    "get_tracer",
    "latency_buckets",
    "pow2_buckets",
    "set_tracer",
    "tokens_saved_estimate",
    "trace_span",
    "use_tracer",
    "write_chrome_trace",
]
