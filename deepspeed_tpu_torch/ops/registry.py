"""Op registry of the PyTorch port (counterpart of
deepspeed_tpu/ops/registry.py, itself the analog of the reference's
``op_builder`` system: OpBuilder.load / is_compatible and the ALL_OPS
registry).

An op is a module or callable with, where the JAX package had a Pallas
kernel, a hand-written CUDA kernel and its plain PyTorch version beside it.
The seam is the reference's: name → builder → ``is_compatible()`` →
``load()``. A builder resolves its accelerator when it is made, so with no
card ``get_op_builder(name)()`` raises unless the caller passes
``get_accelerator("cpu")``.
"""

from __future__ import annotations

from typing import Dict, Type


class OpBuilder:
    NAME: str = "abstract"

    def __init__(self, accelerator=None):
        from deepspeed_tpu_torch.accelerator import get_accelerator

        self.accelerator = accelerator or get_accelerator()

    def is_compatible(self, verbose: bool = False) -> bool:
        return True

    def compatibility_reason(self) -> str:
        return "compatible"

    def load(self):
        """Return the op implementation (module or callable)."""
        raise NotImplementedError

    @property
    def name(self) -> str:
        return self.NAME


class CudaOpBuilder(OpBuilder):
    """Ops whose fast path is a hand-written CUDA kernel (the JAX package's
    PallasOpBuilder). On a CPU accelerator they run their plain versions."""

    def has_fast_path(self) -> bool:
        return self.accelerator.device().type == "cuda"


_OP_BUILDERS: Dict[str, Type[OpBuilder]] = {}


def register_op_builder(cls: Type[OpBuilder]) -> Type[OpBuilder]:
    _OP_BUILDERS[cls.NAME] = cls
    return cls


def get_op_builder(name: str) -> Type[OpBuilder]:
    from . import _register_all  # noqa: F401  (populate registry lazily)

    if name not in _OP_BUILDERS:
        raise KeyError(f"unknown op builder '{name}'. known: {sorted(_OP_BUILDERS)}")
    return _OP_BUILDERS[name]


def all_ops() -> Dict[str, Type[OpBuilder]]:
    from . import _register_all  # noqa: F401

    return dict(_OP_BUILDERS)
