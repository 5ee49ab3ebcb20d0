"""Continuous-batching serving runtime of the PyTorch port (slot-paged and
block-paged with radix prefix sharing; chunked prefill, priority preemption
with host KV swap, sampling, cancel, speculative decoding, span tracing):
see serving/engine.py. The fault-tolerant multi-replica fabric — router,
circuit breakers, replica supervisor, elastic autoscaler and the digital
twin — lives in serving/fabric/, its typed errors in serving/errors.py."""

from deepspeed_tpu_torch.serving.engine import ServingEngine  # noqa: F401
from deepspeed_tpu_torch.serving.errors import (  # noqa: F401
    EmptyPromptError, EngineConfigError, EngineInvariantError, EngineTypeError,
    FabricError, InvalidMaxNewTokensError, InvalidRequestError,
    KVLifecycleError, LastReplicaError, NoHealthyReplicaError,
    PromptTooLongError, ReplicaAdmissionError, ReplicaCrashedError,
    RetriesExhaustedError, RouterOverloadedError, ServingError,
    SlotCapacityError, SwapCapacityError, TransientReplicaError,
    UnknownReplicaError)
from deepspeed_tpu_torch.serving.fabric import (  # noqa: F401
    CircuitBreaker, ElasticAutoscaler, FabricRouter, InProcessReplica, Replica,
    ReplicaHealth, ReplicaSupervisor, ScaleDecision, TwinReport, run_twin,
    synthetic_tenant_trace)
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
