"""Master config (port of deepspeed_tpu/runtime/config.py) — analog of
reference ``deepspeed/runtime/config.py`` (DeepSpeedConfig, config.py:674).

One JSON/dict config parsed once into typed sections, with the reference's
key names. The batch-size triple is solved with the same arithmetic
(``_set_batch_related_parameters``); ``world_size`` defaults to 1, the one
card the port trains on.

The sections the port runs are parsed whole; those whose subsystem it
does not run yet are read for the switch that turns them on, are listed by
:meth:`DeepSpeedConfig.not_ported` when on, and the training engine raises
:class:`NotPortedError` for them rather than quietly training without
them. ``telemetry`` (on by default, as in the reference) and
``wall_clock_breakdown`` run.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Optional, Union

from deepspeed_tpu_torch.errors import DeepSpeedConfigError, NotPortedError  # noqa: F401
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import (
    DeepSpeedConfigModel,
    dict_raise_error_on_duplicate_keys,
)
from deepspeed_tpu_torch.runtime.zero.config import (DeepSpeedZeroConfig,
                                                     OffloadDeviceEnum,
                                                     ZeroStageEnum)
from deepspeed_tpu_torch.telemetry.config import TelemetryConfig


class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False


class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False


class OptimizerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = {}
    legacy_fusion: bool = False


class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = {}


class CheckpointConfig(DeepSpeedConfigModel):
    """The ``checkpoint`` section (reference CheckpointConfig): the port
    reads ``async_save`` (the background-thread engine). The reference's
    other keys (``tag_validation``, the storage options) change nothing on
    one device and are kept as attributes."""

    async_save: bool = False


class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: Optional[str] = None


# Sections of subsystems the port does not run yet declare only the fields
# it reads; their other keys are kept as attributes all the same.
class TensorParallelConfig(DeepSpeedConfigModel):
    tp_size: int = 1


class PipelineConfig(DeepSpeedConfigModel):
    stages: int = 1


class SequenceParallelConfig(DeepSpeedConfigModel):
    sp_size: int = 1


class ExpertParallelConfig(DeepSpeedConfigModel):
    ep_size: int = 1


class EnabledConfig(DeepSpeedConfigModel):
    """A section that matters to the port only through ``enabled``: the
    hybrid engine, progressive layer drop, the monitor backends, the flops
    profiler, the comms logger."""

    enabled: bool = False


class ResilienceConfig(DeepSpeedConfigModel):
    """The reference's anomaly sentinel + recovery section. ``enabled`` (the
    sentinel) is not ported; ``check_finite_grads`` (the skip-and-count
    guard on nonfinite grads, default: follows ``enabled``) is."""

    enabled: bool = False
    check_finite_grads: Optional[bool] = None


_MONITORS = ("tensorboard", "wandb", "csv_monitor", "jsonl_monitor")


def _read_config_dict(config: Union[str, dict]) -> dict:
    if isinstance(config, dict):
        return copy.deepcopy(config)
    if isinstance(config, str):
        if not os.path.exists(config):
            raise DeepSpeedConfigError(f"config path does not exist: {config}")
        with open(config) as f:
            return json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
    raise DeepSpeedConfigError(f"unsupported config type {type(config)}")


class DeepSpeedConfig:
    """Parsed, validated config tree (reference DeepSpeedConfig)."""

    def __init__(self, config: Union[str, dict], mpu=None,
                 world_size: Optional[int] = None):
        self._param_dict = _read_config_dict(config)
        d = self._param_dict

        # ---------------- parallel degrees (needed for batch arithmetic) ------
        self.tensor_parallel = TensorParallelConfig(**d.get(C.TENSOR_PARALLEL, {}))
        self.pipeline = PipelineConfig(**d.get(C.PIPELINE, {})) if isinstance(
            d.get(C.PIPELINE, {}), dict) else PipelineConfig()
        self.sequence_parallel = SequenceParallelConfig(**d.get(C.SEQUENCE_PARALLEL, {}))
        self.expert_parallel = ExpertParallelConfig(
            **({"ep_size": d[C.EXPERT_PARALLEL_SIZE]} if C.EXPERT_PARALLEL_SIZE in d else {}))
        self.world_size = 1 if world_size is None else int(world_size)
        denom = (self.tensor_parallel.tp_size * self.pipeline.stages *
                 self.sequence_parallel.sp_size)
        self.data_parallel_size = max(self.world_size // max(denom, 1), 1)

        # ---------------- batch triple ---------------------------------------
        self.train_batch_size = d.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = d.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = d.get(C.GRADIENT_ACCUMULATION_STEPS)
        self._set_batch_related_parameters()

        # ---------------- precision ------------------------------------------
        self.fp16_config = FP16Config(**d.get(C.FP16, {}))
        self.bf16_config = BF16Config(**d.get(C.BFLOAT16, d.get(C.BFLOAT16_OLD, {})))
        self.fp16_enabled = self.fp16_config.enabled
        self.bfloat16_enabled = self.bf16_config.enabled
        if self.fp16_enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        gad = d.get(C.DATA_TYPES, {}).get("grad_accum_dtype")
        if gad not in (None, "fp32", "bf16"):
            raise DeepSpeedConfigError(
                f"data_types.grad_accum_dtype must be fp32 or bf16, got {gad!r}")
        self.grad_accum_dtype = gad or "fp32"
        self.gradient_clipping = float(d.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT))

        # ---------------- optimizer / scheduler -------------------------------
        opt_dict = d.get(C.OPTIMIZER, {})
        self.optimizer = OptimizerConfig(**opt_dict) if opt_dict else None
        self.optimizer_name = self.optimizer.type.lower() if self.optimizer and \
            self.optimizer.type else None
        self.optimizer_params = self.optimizer.params if self.optimizer else {}
        sched_dict = d.get(C.SCHEDULER, {})
        self.scheduler = SchedulerConfig(**sched_dict) if sched_dict else None
        self.scheduler_name = self.scheduler.type if self.scheduler else None
        self.scheduler_params = self.scheduler.params if self.scheduler else {}

        # ---------------- zero ------------------------------------------------
        self.zero_config = DeepSpeedZeroConfig(**d.get("zero_optimization", {}))
        self.zero_optimization_stage = int(self.zero_config.stage)
        self.zero_enabled = self.zero_optimization_stage > 0

        # ---------------- subsystems -----------------------------------------
        self.activation_checkpointing_config = ActivationCheckpointingConfig(
            **d.get(C.ACTIVATION_CHECKPOINTING, {}))
        self.checkpoint_config = CheckpointConfig(**d.get(C.CHECKPOINT, {}))
        self.monitor_config = {k: EnabledConfig(**d.get(k, {}))
                               for k in _MONITORS}
        self.telemetry_config = TelemetryConfig(**d.get("telemetry", {}))
        self.flops_profiler_config = EnabledConfig(**d.get("flops_profiler", {}))
        self.comms_logger_config = EnabledConfig(**d.get("comms_logger", {}))
        self.resilience_config = ResilienceConfig(**d.get(C.RESILIENCE, {}))
        self.hybrid_engine = EnabledConfig(**d.get("hybrid_engine", {}))
        self.pld_config = EnabledConfig(**d.get("progressive_layer_drop", {}))
        rltd = d.get(C.DATA_EFFICIENCY, {}).get("data_routing", {}).get("random_ltd", {})
        self.random_ltd_enabled = bool(rltd.get("enabled", False))
        self.curriculum_enabled_legacy = bool(
            d.get("curriculum_learning", {}).get("enabled", False))
        self.dataloader_drop_last = d.get(C.DATALOADER_DROP_LAST, C.DATALOADER_DROP_LAST_DEFAULT)

        # ---------------- misc ------------------------------------------------
        self.steps_per_print = d.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.wall_clock_breakdown = d.get(C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = d.get(C.MEMORY_BREAKDOWN, C.MEMORY_BREAKDOWN_DEFAULT)
        self.seed = d.get(C.SEED, C.SEED_DEFAULT)
        self.elasticity_enabled = bool(d.get(C.ELASTICITY, {}).get("enabled", False))

        self._do_sanity_check()

    # --- reference config.py:904 _set_batch_related_parameters, same logic ----
    def _set_batch_related_parameters(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        dp = self.data_parallel_size

        if train_batch is not None and micro_batch is not None and grad_acc is not None:
            pass
        elif train_batch is not None and micro_batch is not None:
            grad_acc = train_batch // micro_batch
            grad_acc //= dp
            self.gradient_accumulation_steps = grad_acc
        elif train_batch is not None and grad_acc is not None:
            micro_batch = train_batch // dp
            micro_batch //= grad_acc
            self.train_micro_batch_size_per_gpu = micro_batch
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * dp
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // dp
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * dp
            self.gradient_accumulation_steps = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")

    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        assert train_batch > 0, f"train_batch_size: {train_batch} has to be greater than 0"
        assert micro_batch > 0, f"micro_batch: {micro_batch} has to be greater than 0"
        assert grad_acc > 0, f"gradient_accumulation_steps: {grad_acc} has to be greater than 0"
        assert train_batch == micro_batch * grad_acc * self.data_parallel_size, (
            f"Check batch related parameters. train_batch_size is not equal to "
            f"micro_batch_per_gpu * gradient_acc_step * world_size "
            f"{train_batch} != {micro_batch} * {grad_acc} * {self.data_parallel_size}")

    def _do_sanity_check(self):
        self._batch_assertion()
        if self.zero_optimization_stage > ZeroStageEnum.max_stage:
            raise DeepSpeedConfigError(
                f"max zero stage is {int(ZeroStageEnum.max_stage)}, got "
                f"{self.zero_optimization_stage}")

    def not_ported(self) -> List[str]:
        """The enabled options whose subsystem the port does not run yet."""
        zc = self.zero_config
        offload = any(sub is not None and sub.device != OffloadDeviceEnum.none
                      for sub in (zc.offload_optimizer, zc.offload_param))
        checks = {
            f"zero_optimization.stage={self.zero_optimization_stage}":
                self.zero_optimization_stage > 0,
            "zero_optimization offload": offload,
            f"pipeline.stages={self.pipeline.stages}": self.pipeline.stages > 1,
            "hybrid_engine": self.hybrid_engine.enabled,
            f"tensor_parallel.tp_size={self.tensor_parallel.tp_size}":
                self.tensor_parallel.tp_size > 1,
            f"sequence_parallel.sp_size={self.sequence_parallel.sp_size}":
                self.sequence_parallel.sp_size > 1,
            f"ep_size={self.expert_parallel.ep_size}":
                self.expert_parallel.ep_size > 1,
            "progressive_layer_drop": self.pld_config.enabled,
            "random_ltd": self.random_ltd_enabled,
            "curriculum_learning": self.curriculum_enabled_legacy,
            "monitor (" + ", ".join(_MONITORS) + ")": any(
                m.enabled for m in self.monitor_config.values()),
            "flops_profiler": self.flops_profiler_config.enabled,
            "comms_logger": self.comms_logger_config.enabled,
            "resilience (sentinel)": self.resilience_config.enabled,
            "elasticity": self.elasticity_enabled,
            # activation_checkpointing is parsed and, as in the reference,
            # not read by the engine: a model's remat follows its own
            # remat / remat_policy and the options that
            # runtime/activation_checkpointing.configure() was given
        }
        return [name for name, on in checks.items() if on]
