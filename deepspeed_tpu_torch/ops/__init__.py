"""Ops of the PyTorch port and their builders (the JAX package's
``deepspeed_tpu/ops/__init__.py``).

Each module that holds a hand-written CUDA kernel (decode_step,
int8_matmul, flash_attention, flash_decode, sparse_attention/block_sparse)
keeps its plain PyTorch version beside it and a launch counter on its
wrapper (``fused_decode_step.launches``, ``int8_matmul_dma.launches``,
``int8_matmul.launches``, ``flash_decode.launches``,
``block_sparse_fwd.launches``, ...).

``get_op_builder(name)`` lists the same names as the JAX package. The
ported ops load their module or class; ``load()`` of the others raises
:class:`NotPortedError`.
"""

from deepspeed_tpu_torch.errors import NotPortedError

from . import registry as _registry_mod
from .registry import OpBuilder, all_ops, get_op_builder, register_op_builder  # noqa: F401


class _register_all:
    """Importing this module registers the built-in op builders."""


@register_op_builder
class FusedAdamBuilder(_registry_mod.OpBuilder):
    NAME = "fused_adam"

    def load(self):
        from deepspeed_tpu_torch.ops.adam import FusedAdam

        return FusedAdam


@register_op_builder
class FusedLambBuilder(_registry_mod.OpBuilder):
    NAME = "fused_lamb"

    def load(self):
        from deepspeed_tpu_torch.ops.adam import FusedLamb

        return FusedLamb


@register_op_builder
class AttentionBuilder(_registry_mod.CudaOpBuilder):
    NAME = "attention"

    def load(self):
        from deepspeed_tpu_torch.ops import attention

        return attention


@register_op_builder
class FlashAttentionBuilder(_registry_mod.CudaOpBuilder):
    NAME = "flash_attention"

    def load(self):
        from deepspeed_tpu_torch.ops import flash_attention

        return flash_attention


@register_op_builder
class SparseAttnBuilder(_registry_mod.CudaOpBuilder):
    """Block-sparse attention: the sparsity config family and the LUT-driven
    CUDA kernels (ops/sparse_attention)."""

    NAME = "sparse_attn"

    def load(self):
        from deepspeed_tpu_torch.ops import sparse_attention

        return sparse_attention


class _NotPortedBuilder(_registry_mod.OpBuilder):
    """An op of the JAX package that the port does not run yet."""

    def is_compatible(self, verbose: bool = False) -> bool:
        return False

    def compatibility_reason(self) -> str:
        return f"op '{self.NAME}' is not ported to PyTorch yet"

    def load(self):
        raise NotPortedError(self.compatibility_reason())


for _name in ("cpu_adam", "cpu_adagrad", "ring_attention", "async_io",
              "onebit", "cpu_adam_native"):
    register_op_builder(type(f"NotPorted_{_name}", (_NotPortedBuilder,),
                             {"NAME": _name}))
