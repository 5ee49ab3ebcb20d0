"""ZeRO-Infinity's swap subsystem (port of deepspeed_tpu/runtime/swap_tensor/)
over the native async IO engine (ops/aio.py), on torch CPU tensors."""

from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import AsyncTensorSwapper
from deepspeed_tpu_torch.runtime.swap_tensor.buffer_pool import SwapBufferPool
from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import (
    OptimizerSwapper,
    PipelinedOptimizerSwapper,
)
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import (
    AsyncPartitionedParameterSwapper,
    PartitionedParamStatus,
)

__all__ = ["AsyncTensorSwapper", "SwapBufferPool", "OptimizerSwapper",
           "PipelinedOptimizerSwapper", "AsyncPartitionedParameterSwapper",
           "PartitionedParamStatus"]
