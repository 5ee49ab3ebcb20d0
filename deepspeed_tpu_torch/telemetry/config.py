"""Telemetry config section of the port (port of
deepspeed_tpu/telemetry/config.py): ``"telemetry": {...}`` in the config.

Keys:
  enabled        — master switch for engine and serving instrumentation
                   (default true).
  jsonl_path     — when non-empty, a :class:`JsonlSink` at this path is
                   attached to the global registry (snapshots, events,
                   spans and attribution rows stream there; render with
                   scripts/telemetry_report.py).
  sync_interval  — every N global steps (and at step 1) the training
                   engine fences the device (one ``torch.cuda.synchronize``)
                   to read device-time step latency, tokens/s, MFU,
                   grad-norm, loss, skip counters and memory. 0 never
                   fences (those gauges then stay unset).
  cost_analysis  — the FLOPs behind ``train/mfu`` and the train step's
                   roofline row. True: the analytic count of the step
                   (``model.flops_per_token(T)`` times the step's tokens,
                   the forward, backward and attention FLOPs; bytes: the
                   update's traffic, see ``DeepSpeedEngine._train_step_flops``).
                   False: the reference's fallback, ``6 * N * tokens``
                   with no bytes. (The reference's True lowers the step
                   through XLA's cost_analysis, which torch lacks.)
  spans          — arm the span tracer: a ``step_window`` span per
                   fence-to-fence window, stamped at fences that already
                   exist (default off).
  spans_path     — JSONL file for span records; empty reuses jsonl_path's
                   sink.
  flight_recorder — arm the flight recorder: bounded rings of recent
                   spans, events and snapshots teed off the JSONL stream
                   (default off).
  flight_dir     — directory for flight-recorder dumps
                   (``flight_<NNN>_<reason>.json``); empty records
                   triggers without writing files.
"""

from __future__ import annotations

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class TelemetryConfig(DeepSpeedConfigModel):
    enabled: bool = True
    jsonl_path: str = ""
    sync_interval: int = 50
    cost_analysis: bool = True
    spans: bool = False
    spans_path: str = ""
    flight_recorder: bool = False
    flight_dir: str = ""


def get_telemetry_config(param_dict: dict) -> TelemetryConfig:
    return TelemetryConfig(**param_dict.get("telemetry", {}))
