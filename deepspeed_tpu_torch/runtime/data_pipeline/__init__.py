"""Data efficiency (port of deepspeed_tpu/runtime/data_pipeline): the
curriculum scheduler and sampler, the indexed dataset and its analyzer,
and random-LTD token routing."""

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampler import DeepSpeedDataSampler
from deepspeed_tpu_torch.runtime.data_pipeline.random_ltd import (
    RandomLTDScheduler,
    gather_tokens,
    random_ltd_token_drop,
    scatter_tokens,
)

__all__ = ["CurriculumScheduler", "DeepSpeedDataSampler", "RandomLTDScheduler",
           "gather_tokens", "scatter_tokens", "random_ltd_token_drop"]
