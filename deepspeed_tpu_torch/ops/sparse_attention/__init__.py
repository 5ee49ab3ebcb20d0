"""Block-sparse attention of the PyTorch port (the JAX package's
``ops/sparse_attention``): the sparsity config family, the LUT-driven CUDA
kernels behind :func:`block_sparse_attention`, and ``SparseSelfAttention``."""

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    LocalSlidingWindowSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import (
    block_sparse_attention,
    block_sparse_attention_reference,
    layout_to_dense_mask,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention,
)
