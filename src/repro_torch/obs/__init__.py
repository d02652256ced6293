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
(:mod:`repro_torch.obs.names` is a verbatim copy), but for the spans the
port adds inside ``engine.generate`` (``engine.prefill``,
``engine.decode_step``), catalogued in :mod:`repro_torch.obs.port_names`.
``tools/check_trace.py`` reads the reference's catalog alone, so it holds
model-free traces, such as the quickstart's; a trace in which a model
serves is checked against both catalogs (``names.SPAN_NAMES +
port_names.SPAN_NAMES``), as ``chip_smoke.py``'s ``check_span_forest`` does.
The clock is injectable, and ``profiler_clock`` puts spans on
``torch.profiler``'s timebase.
``python -m repro_torch.obs`` runs a traced quickstart of the serving path.
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
    profiler_clock,
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
    "profiler_clock",
    "set_tracer",
    "tokens_saved_estimate",
    "trace_span",
    "use_tracer",
    "write_chrome_trace",
]
