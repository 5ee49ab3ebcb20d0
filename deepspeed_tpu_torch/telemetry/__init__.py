"""Telemetry of the port (port of deepspeed_tpu/telemetry: the registry,
the JSONL sink, the config section, MFU and trace capture).

* :mod:`registry` — counters, gauges and fixed-bucket latency histograms
  with p50/p95/p99; a process-global default registry and
  :func:`record_event`.
* :mod:`sink`     — the JSONL sink and its torn-line-tolerant reader.
* :mod:`trace`    — ``trace(path)`` over ``torch.profiler`` and
  ``annotate(name)``.
* :mod:`mfu`      — model-flops utilization against the card's peak.
* :mod:`spans`    — the span-graph request tracer (``ServingEngine(
  tracer=SpanTracer())``), its Chrome-trace export and the per-request
  phase breakdowns.

``serving/engine.py`` records into the registry: requests finished,
prefills, latency / queue-wait / TTFT / TPOT histograms, deadline sheds,
and per run the compile-once contract (``serving/compiled_programs``,
``serving/jit_cache_entries``, ``serving/recompiles``).
"""

from deepspeed_tpu_torch.telemetry.config import TelemetryConfig, get_telemetry_config
from deepspeed_tpu_torch.telemetry.mfu import mfu, peak_flops_per_sec
from deepspeed_tpu_torch.telemetry.registry import (
    DEFAULT_LATENCY_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    metric_label,
    record_event,
    reset_registry,
    sanitize_metric_name,
)
from deepspeed_tpu_torch.telemetry.sink import JsonlSink, read_jsonl
from deepspeed_tpu_torch.telemetry.spans import (PHASE_OF_SPAN, PHASES, Span,
                                                 SpanTracer,
                                                 aggregate_phase_stats,
                                                 phase_breakdown,
                                                 trace_summaries)
from deepspeed_tpu_torch.telemetry.trace import annotate, trace

__all__ = [
    "DEFAULT_LATENCY_BUCKETS_MS",
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "PHASES",
    "PHASE_OF_SPAN",
    "Span",
    "SpanTracer",
    "TelemetryConfig",
    "aggregate_phase_stats",
    "annotate",
    "get_registry",
    "get_telemetry_config",
    "metric_label",
    "mfu",
    "peak_flops_per_sec",
    "phase_breakdown",
    "read_jsonl",
    "record_event",
    "reset_registry",
    "sanitize_metric_name",
    "trace",
    "trace_summaries",
]
