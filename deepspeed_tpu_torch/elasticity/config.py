"""Elasticity config (port of deepspeed_tpu/elasticity/config.py) — analog of
reference ``deepspeed/elasticity/config.py``
(ElasticityConfig and the error types)."""

from __future__ import annotations

from typing import List

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class ElasticityError(Exception):
    """Base elasticity error (reference elasticity/constants + errors)."""


class ElasticityConfigError(ElasticityError):
    pass


class ElasticityIncompatibleWorldSize(ElasticityError):
    pass


LATEST_ELASTICITY_VERSION = 0.2


class ElasticityConfig(DeepSpeedConfigModel):
    """Fields mirror reference elasticity config (max_train_batch_size,
    micro_batch_sizes, min/max_gpus, min_time, prefer_larger_batch,
    ignore_non_elastic_batch_info, version)."""

    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = [2, 4, 6]
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    prefer_larger_batch: bool = True
    ignore_non_elastic_batch_info: bool = False
    version: float = 0.2
    model_parallel_size: int = 1

    def validate(self):
        if self.max_train_batch_size < 1:
            raise ElasticityConfigError(
                f"max_train_batch_size must be >= 1, got {self.max_train_batch_size}")
        if not self.micro_batch_sizes or any(m < 1 for m in self.micro_batch_sizes):
            raise ElasticityConfigError(
                f"micro_batch_sizes must be positive, got {self.micro_batch_sizes}")
        if self.min_gpus < 1 or self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(
                f"need 1 <= min_gpus <= max_gpus, got [{self.min_gpus}, {self.max_gpus}]")
        if self.version > LATEST_ELASTICITY_VERSION:
            raise ElasticityConfigError(
                f"elasticity version {self.version} > latest supported "
                f"{LATEST_ELASTICITY_VERSION}")
        return self
