"""Continuous-batching serving runtime of the PyTorch port (slot-paged and
block-paged with radix prefix sharing; chunked prefill, priority preemption
with host KV swap, sampling, cancel, speculative decoding, span tracing):
see serving/engine.py."""

from deepspeed_tpu_torch.serving.engine import ServingEngine  # noqa: F401
from deepspeed_tpu_torch.serving.errors import (  # noqa: F401
    EmptyPromptError, EngineConfigError, EngineInvariantError, EngineTypeError,
    InvalidMaxNewTokensError, InvalidRequestError, KVLifecycleError,
    PromptTooLongError, ServingError, SlotCapacityError, SwapCapacityError)
from deepspeed_tpu_torch.serving.kv_blocks import BlockKVPool  # noqa: F401
from deepspeed_tpu_torch.serving.kv_slots import SlotKVCache  # noqa: F401
from deepspeed_tpu_torch.serving.radix import PrefixCache  # noqa: F401
from deepspeed_tpu_torch.serving.scheduler import (  # noqa: F401
    Request, RequestResult, SlotScheduler, bimodal_trace, bursty_poisson_trace,
    pick_bucket, poisson_trace, shared_prefix_trace, straggler_trace,
    templated_trace)
from deepspeed_tpu_torch.serving.speculative import (  # noqa: F401
    SpeculativeConfig, ngram_propose)
from deepspeed_tpu_torch.serving.swap import HostSwapBuffer  # noqa: F401
