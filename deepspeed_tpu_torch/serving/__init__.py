"""Continuous-batching serving runtime of the PyTorch port (slot-paged,
greedy): see serving/engine.py."""

from deepspeed_tpu_torch.serving.engine import ServingEngine  # noqa: F401
from deepspeed_tpu_torch.serving.errors import (  # noqa: F401
    EmptyPromptError, EngineConfigError, EngineInvariantError,
    InvalidMaxNewTokensError, InvalidRequestError, PromptTooLongError,
    ServingError, SlotCapacityError)
from deepspeed_tpu_torch.serving.kv_slots import SlotKVCache  # noqa: F401
from deepspeed_tpu_torch.serving.scheduler import (  # noqa: F401
    Request, RequestResult, SlotScheduler, pick_bucket, poisson_trace)
