"""Fault-injection seams for robustness tests (port of
deepspeed_tpu/testing/)."""

from deepspeed_tpu_torch.testing.fault_injection import (
    AlertStormPlan,
    FakeClock,
    FaultInjector,
    PoisonedDataset,
    ReplicaFaultPlan,
    ScriptedWorkerGroup,
    SimulatedCrash,
    corrupt_file,
    flip_param_bit,
    poison_sample,
)

__all__ = ["AlertStormPlan", "FakeClock", "FaultInjector", "PoisonedDataset",
           "ReplicaFaultPlan", "ScriptedWorkerGroup", "SimulatedCrash",
           "corrupt_file", "flip_param_bit", "poison_sample"]
