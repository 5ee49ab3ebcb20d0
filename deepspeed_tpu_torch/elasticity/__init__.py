"""Elasticity (port of deepspeed_tpu/elasticity/): the elastic batch
ladder, preemption-aware shutdown and the restart-on-failure agent. Host
logic only: nothing here touches the card."""

from deepspeed_tpu_torch.elasticity.config import (
    ElasticityConfig,
    ElasticityConfigError,
    ElasticityError,
    ElasticityIncompatibleWorldSize,
)
from deepspeed_tpu_torch.elasticity.elasticity import (
    compute_elastic_config,
    elasticity_enabled,
    get_candidate_batch_sizes,
    get_valid_gpus,
)
from deepspeed_tpu_torch.elasticity.preemption import (
    PREEMPTION_EXIT_CODE,
    PreemptionHandler,
)

__all__ = ["ElasticityConfig", "ElasticityConfigError", "ElasticityError",
           "ElasticityIncompatibleWorldSize", "compute_elastic_config",
           "elasticity_enabled", "get_candidate_batch_sizes", "get_valid_gpus",
           "PREEMPTION_EXIT_CODE", "PreemptionHandler"]
