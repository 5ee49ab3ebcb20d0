"""Ops of the PyTorch port and their builders (the JAX package's
``deepspeed_tpu/ops/__init__.py``).

Each module that holds a hand-written CUDA kernel (decode_step,
int8_matmul, flash_attention, flash_decode, sparse_attention/block_sparse)
keeps its plain PyTorch version beside it and a launch counter on its
wrapper (``fused_decode_step.launches``, ``int8_matmul_dma.launches``,
``int8_matmul.launches``, ``flash_decode.launches``,
``block_sparse_fwd.launches``, ...).

The host ops (``cpu_adam_native``, ``async_io``) are the JAX package's
own C++ (``deepspeed_tpu_torch/csrc/adam``, ``csrc/aio``), built by
``ops/native/builder.py``; their builders' accelerator is the CPU's.

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
class CPUAdamBuilder(_registry_mod.OpBuilder):
    NAME = "cpu_adam"

    def load(self):
        from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam

        return DeepSpeedCPUAdam


@register_op_builder
class FusedLambBuilder(_registry_mod.OpBuilder):
    NAME = "fused_lamb"

    def load(self):
        from deepspeed_tpu_torch.ops.adam import FusedLamb

        return FusedLamb


@register_op_builder
class CPUAdagradBuilder(_registry_mod.OpBuilder):
    NAME = "cpu_adagrad"

    def load(self):
        from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdagrad

        return DeepSpeedCPUAdagrad


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


def _native_builder_base():
    from deepspeed_tpu_torch.ops.native.builder import NativeOpBuilder

    return NativeOpBuilder


class _NativeBuilderProxy(_registry_mod.OpBuilder):
    """A host C++ op; the native builder's machinery is imported at first
    use (the reference's proxy)."""

    SOURCES: list = []
    WANT_OPENMP = False
    WANT_SIMD = False

    def __init__(self, accelerator=None):
        if accelerator is None:
            from deepspeed_tpu_torch.accelerator import get_accelerator

            accelerator = get_accelerator("cpu")
        super().__init__(accelerator)

    def _impl(self):
        cached = getattr(self, "_impl_cache", None)
        if cached is None:
            cls = type(self.NAME, (_native_builder_base(),), {
                "NAME": self.NAME, "SOURCES": self.SOURCES,
                "WANT_OPENMP": self.WANT_OPENMP, "WANT_SIMD": self.WANT_SIMD})
            cached = self._impl_cache = cls(self.accelerator)
        return cached

    def is_compatible(self, verbose: bool = False) -> bool:
        return self._impl().is_compatible(verbose)

    def compatibility_reason(self) -> str:
        return self._impl().compatibility_reason()

    def build_flags(self):
        return self._impl().build_flags()

    def load_library(self):
        return self._impl().load_library()


@register_op_builder
class AsyncIOBuilder(_NativeBuilderProxy):
    """The async file IO engine (reference csrc/aio; op name 'async_io')."""

    NAME = "async_io"
    SOURCES = ["aio/dstpu_aio.cpp"]

    def load(self):
        from deepspeed_tpu_torch.ops import aio

        return aio


@register_op_builder
class CPUAdamNativeBuilder(_NativeBuilderProxy):
    """The host Adam / Adagrad kernels of the ZeRO-Offload step (reference
    csrc/adam/cpu_adam.cpp)."""

    NAME = "cpu_adam_native"
    SOURCES = ["adam/dstpu_cpu_adam.cpp"]
    WANT_OPENMP = True
    WANT_SIMD = True

    def load(self):
        from deepspeed_tpu_torch.ops import cpu_adam_native

        return cpu_adam_native


class _NotPortedBuilder(_registry_mod.OpBuilder):
    """An op of the JAX package that the port does not run yet."""

    def is_compatible(self, verbose: bool = False) -> bool:
        return False

    def compatibility_reason(self) -> str:
        return f"op '{self.NAME}' is not ported to PyTorch yet"

    def load(self):
        raise NotPortedError(self.compatibility_reason())


for _name in ("ring_attention", "onebit"):
    register_op_builder(type(f"NotPorted_{_name}", (_NotPortedBuilder,),
                             {"NAME": _name}))
