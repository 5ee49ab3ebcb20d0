"""Telemetry of the port (port of deepspeed_tpu/telemetry).

* :mod:`registry`        — counters, gauges and fixed-bucket latency
  histograms with p50/p95/p99; a process-global default registry and
  :func:`record_event`.
* :mod:`sink`            — the JSONL sink and its torn-line-tolerant reader.
* :mod:`trace`           — ``trace(path)`` over ``torch.profiler`` and
  ``annotate(name)``.
* :mod:`mfu`             — model-flops utilization against the card's peak
  (the accelerator layer's table).
* :mod:`spans`           — the span-graph tracer, its Chrome-trace export
  and the per-request phase breakdowns.
* :mod:`attribution`     — per-program roofline rows from an analytic
  FLOP and byte count and the host-observed wall.
* :mod:`slo`             — declarative SLIs and multi-window burn-rate
  alerting on the caller's clock.
* :mod:`tenants`         — per-tenant usage and cost accounting.
* :mod:`flight_recorder` — bounded rings of recent telemetry and
  postmortem dumps on trigger.

Instrumentation points: ``runtime/engine.py`` (step counters, the step
wall, and at the periodic fence device step time, tokens/s, MFU,
grad-norm, loss, skip counters and memory; the ``step_window`` span and
the wall-clock breakdown) and ``serving/engine.py`` (requests, prefills,
latency / queue-wait / TTFT / TPOT histograms, deadline sheds, the
compile-once contract, the SLO engine, the tenant ledger, the prefix
cache's counters and the per-program roofline).
"""

from deepspeed_tpu_torch.telemetry.attribution import (accelerator_peaks,
                                                       attribution_table,
                                                       model_cost,
                                                       program_cost,
                                                       roofline_row,
                                                       work_cost)
from deepspeed_tpu_torch.telemetry.config import TelemetryConfig, get_telemetry_config
from deepspeed_tpu_torch.telemetry.flight_recorder import FlightRecorder
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
from deepspeed_tpu_torch.telemetry.slo import (DEFAULT_SLO_CONFIG, SLI,
                                               BurnRateRule, SLOAlert,
                                               SLOConfigError, SLOEngine,
                                               parse_slo_config,
                                               validate_slo_config)
from deepspeed_tpu_torch.telemetry.spans import (PHASE_OF_SPAN, PHASES, Span,
                                                 SpanTracer,
                                                 aggregate_phase_stats,
                                                 phase_breakdown,
                                                 trace_summaries)
from deepspeed_tpu_torch.telemetry.tenants import DEFAULT_TENANT, TenantLedger
from deepspeed_tpu_torch.telemetry.trace import annotate, trace

__all__ = [
    "BurnRateRule",
    "DEFAULT_LATENCY_BUCKETS_MS",
    "DEFAULT_SLO_CONFIG",
    "DEFAULT_TENANT",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "PHASES",
    "PHASE_OF_SPAN",
    "SLI",
    "SLOAlert",
    "SLOConfigError",
    "SLOEngine",
    "Span",
    "SpanTracer",
    "TelemetryConfig",
    "TenantLedger",
    "accelerator_peaks",
    "aggregate_phase_stats",
    "annotate",
    "attribution_table",
    "get_registry",
    "get_telemetry_config",
    "metric_label",
    "mfu",
    "model_cost",
    "parse_slo_config",
    "peak_flops_per_sec",
    "phase_breakdown",
    "program_cost",
    "read_jsonl",
    "record_event",
    "reset_registry",
    "roofline_row",
    "sanitize_metric_name",
    "trace",
    "trace_summaries",
    "validate_slo_config",
    "work_cost",
]
