"""Flops-profiler config (port of deepspeed_tpu/profiling/config.py) —
analog of reference ``deepspeed/profiling/config.py``."""

from __future__ import annotations

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class DeepSpeedFlopsProfilerConfig(DeepSpeedConfigModel):
    enabled: bool = False
    recompute_fwd_factor: float = 0.0
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: str = ""


def get_flops_profiler_config(param_dict: dict) -> DeepSpeedFlopsProfilerConfig:
    return DeepSpeedFlopsProfilerConfig(**param_dict.get("flops_profiler", {}))
