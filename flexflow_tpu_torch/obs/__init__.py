"""Unified telemetry: tracing, metrics, audit records.

The port of ``flexflow_tpu/obs``, wired through the executor, the
training loop, generation and the resilience runtime:

  - :mod:`.events` — thread-safe ring-buffered span/counter recorder,
    near-zero-cost when disabled, enabled via ``FF_TRACE=1`` or
    ``FFConfig.trace``;
  - :mod:`.trace_export` — Chrome trace-event JSON export of the
    recorded spans (Perfetto / TensorBoard-viewable) plus the per-rank
    ring dumps ``tools/fftrace.py`` merges;
  - :mod:`.metrics_registry` — counters/gauges/histograms with
    Prometheus text exposition, byte for byte the JAX package's;
  - :mod:`.audit` — per-op predicted-cost breakdowns of each search
    adoption, persisted to ``.ffcache/strategy_audit_<hash>.json``;
  - :mod:`.request_trace` — per-request serving lifecycle trace ids,
    read by ``FFModel.generate``'s prefill / decode spans;
  - :mod:`.flight` — bounded flight-recorder dumps at failure sites
    (NaN rollback, unhandled crash);
  - :mod:`.sketch` — the mergeable streaming quantile sketch behind the
    serving fronts' latency quantiles and the fleet's merged metrics.

The JAX package's ``attribution`` and ``drift`` are not ported yet
(ROADMAP queue 1, item 6).
"""
from . import events
from .audit import load_strategy_audit, workload_key
from .events import counter, instant, span
from .metrics_registry import REGISTRY, MetricsRegistry, get_registry
from .request_trace import TRACE_HEADER, RequestTrace
from .sketch import QuantileSketch
from .trace_export import (dump_rank_trace, dump_serving_trace,
                           export_chrome_trace, to_chrome_trace)

__all__ = ["events", "span", "counter", "instant", "REGISTRY",
           "MetricsRegistry", "get_registry", "to_chrome_trace",
           "export_chrome_trace", "dump_rank_trace",
           "dump_serving_trace", "workload_key",
           "load_strategy_audit", "RequestTrace", "TRACE_HEADER",
           "QuantileSketch"]
