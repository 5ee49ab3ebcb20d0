"""Fault-tolerant multi-replica serving fabric (port of
deepspeed_tpu/serving/fabric/).

The traffic layer over N
:class:`~deepspeed_tpu_torch.serving.engine.ServingEngine` replicas:
health-checked least-loaded routing with per-replica circuit breakers,
retry/backoff failover that resumes a dead replica's in-flight requests
on a survivor from the router's committed-token record, bounded-queue
backpressure + priority/deadline load shedding, an ElasticAgent-style
replica supervisor, the SLO-alert-driven elastic autoscaler and the
digital twin — all behind the small
:class:`~deepspeed_tpu_torch.serving.fabric.replica.Replica` interface.
Host logic only: the replicas' engines do the device work. Chaos seams
live in ``deepspeed_tpu_torch/testing/fault_injection.py``.
"""

from deepspeed_tpu_torch.serving.fabric.autoscaler import (
    ElasticAutoscaler, ScaleDecision)
from deepspeed_tpu_torch.serving.fabric.health import CircuitBreaker
from deepspeed_tpu_torch.serving.fabric.replica import (InProcessReplica,
                                                        Replica, ReplicaHealth)
from deepspeed_tpu_torch.serving.fabric.router import FabricRouter
from deepspeed_tpu_torch.serving.fabric.supervisor import ReplicaSupervisor
from deepspeed_tpu_torch.serving.fabric.twin import (TWIN_SLO_CONFIG,
                                                     TwinReport, run_twin,
                                                     synthetic_tenant_trace)

__all__ = ["CircuitBreaker", "ElasticAutoscaler", "FabricRouter",
           "InProcessReplica", "Replica", "ReplicaHealth",
           "ReplicaSupervisor", "ScaleDecision", "TWIN_SLO_CONFIG",
           "TwinReport", "run_twin", "synthetic_tenant_trace"]
