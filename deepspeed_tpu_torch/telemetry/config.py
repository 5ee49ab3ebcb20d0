"""Telemetry config section of the port (port of
deepspeed_tpu/telemetry/config.py): ``"telemetry": {...}`` in the config.

Keys:
  enabled        — master switch for engine and serving instrumentation
                   (default true).
  jsonl_path     — when non-empty, a :class:`JsonlSink` at this path is
                   attached to the global registry.
  sync_interval  — every N global steps a training engine would fence the
                   device to read device-time metrics (0: never).
  spans, flight_recorder — the span tracer and the flight recorder, not
                   ported yet: enabling either raises
                   :class:`NotPortedError`.
Other keys of the reference's section are kept as attributes.
"""

from __future__ import annotations

from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class TelemetryConfig(DeepSpeedConfigModel):
    enabled: bool = True
    jsonl_path: str = ""
    sync_interval: int = 50


def get_telemetry_config(param_dict: dict) -> TelemetryConfig:
    cfg = TelemetryConfig(**param_dict.get("telemetry", {}))
    for name in ("spans", "flight_recorder"):
        if getattr(cfg, name, False):
            raise NotPortedError(f"telemetry.{name} is not ported to the "
                                 "PyTorch package yet")
    return cfg
