"""ZeRO config (port of deepspeed_tpu/runtime/zero/config.py) — analog of
reference ``deepspeed/runtime/zero/config.py``.

Same JSON schema (``zero_optimization`` section). The port trains at stage
0 only for now; the engine refuses stage >= 1 and offload as "not ported
yet" (runtime/config.py ``not_ported``)."""

from __future__ import annotations

from enum import Enum
from typing import Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class ZeroStageEnum(int, Enum):
    disabled = 0
    optimizer_states = 1
    gradients = 2
    weights = 3
    max_stage = 3


class OffloadDeviceEnum(str, Enum):
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = int(1e8)
    max_in_cpu: int = int(1e9)
    pin_memory: bool = False


class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False


class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    stage: ZeroStageEnum = ZeroStageEnum.disabled
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None
    sub_group_size: int = int(1e9)
    cpu_offload_param: Optional[bool] = None  # deprecated spellings accepted
    cpu_offload_use_pin_memory: Optional[bool] = None
    cpu_offload: Optional[bool] = None
    prefetch_bucket_size: int = int(5e7)
    param_persistence_threshold: int = int(1e5)
    model_persistence_threshold: int = int(1e14)
    max_live_parameters: int = int(1e9)
    max_reuse_distance: int = int(1e9)
    gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    zero_hpz_partition_size: int = 1
    memory_efficient_linear: bool = True

    _aliases = {f"stage3_{name}": name for name in (
        "prefetch_bucket_size", "param_persistence_threshold",
        "model_persistence_threshold", "max_live_parameters",
        "max_reuse_distance", "gather_16bit_weights_on_model_save")}
    _nested = {"offload_param": DeepSpeedZeroOffloadParamConfig,
               "offload_optimizer": DeepSpeedZeroOffloadOptimizerConfig}

    def __init__(self, **data):
        super().__init__(**data)
        self.stage = ZeroStageEnum(int(self.stage))
        for name in ("offload_param", "offload_optimizer"):
            sub = getattr(self, name)
            if sub is not None:
                sub.device = OffloadDeviceEnum(sub.device)
        # legacy cpu_offload flags fold into the typed offload configs
        if self.cpu_offload and self.offload_optimizer is None:
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(device="cpu")
        if self.cpu_offload_param and self.offload_param is None:
            self.offload_param = DeepSpeedZeroOffloadParamConfig(device="cpu")
