"""Monitor config (port of deepspeed_tpu/monitor/config.py) — analog of
reference ``deepspeed/monitor/config.py``."""

from __future__ import annotations

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class TensorBoardConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


class WandbConfig(DeepSpeedConfigModel):
    enabled: bool = False
    group: str = ""
    team: str = ""
    project: str = "deepspeed_tpu"


class CSVConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


class JsonlConfig(DeepSpeedConfigModel):
    """Structured JSONL writer (the telemetry subsystem's fourth monitor
    backend, no reference analog): every scalar event lands as one
    ``{"kind": "scalar", "tag", "value", "step", "ts"}`` line in
    ``<output_path>/<job_name>.jsonl`` (read it back with
    ``telemetry.read_jsonl``)."""

    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


class DeepSpeedMonitorConfig(DeepSpeedConfigModel):
    tensorboard: TensorBoardConfig = TensorBoardConfig()
    wandb: WandbConfig = WandbConfig()
    csv_monitor: CSVConfig = CSVConfig()
    jsonl_monitor: JsonlConfig = JsonlConfig()

    _nested = {"tensorboard": TensorBoardConfig, "wandb": WandbConfig,
               "csv_monitor": CSVConfig, "jsonl_monitor": JsonlConfig}

    @property
    def enabled(self) -> bool:
        return (self.tensorboard.enabled or self.wandb.enabled or
                self.csv_monitor.enabled or self.jsonl_monitor.enabled)


def get_monitor_config(param_dict: dict) -> DeepSpeedMonitorConfig:
    monitor_dict = {
        k: v for k, v in param_dict.items()
        if k in ("tensorboard", "wandb", "csv_monitor", "jsonl_monitor")
    }
    return DeepSpeedMonitorConfig(**monitor_dict)
