"""The FLOPs profiler (port of deepspeed_tpu/profiling)."""

from deepspeed_tpu_torch.profiling.config import DeepSpeedFlopsProfilerConfig
from deepspeed_tpu_torch.profiling.flops_profiler import (
    FlopsProfiler,
    count_flops,
    get_model_profile,
)

__all__ = ["DeepSpeedFlopsProfilerConfig", "FlopsProfiler", "count_flops",
           "get_model_profile"]
