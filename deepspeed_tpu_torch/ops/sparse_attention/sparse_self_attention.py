"""SparseSelfAttention module (port of
deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py): holds a
SparsityConfig, builds and caches the block layout per sequence length, and
applies :func:`block_sparse_attention`. Also carries the
``pad_to_block_size`` helper of the reference's SparseAttentionUtils, so
inputs of ragged length can use the block kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import (
    block_sparse_attention,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig,
    SparsityConfig,
)


class SparseSelfAttention(torch.nn.Module):
    """Block-sparse self-attention with no parameters: ``forward(query, key,
    value)`` on ``[B, T, H, Dh]``. ``causal`` defaults to the config's
    ``attention == "unidirectional"``."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None):
        super().__init__()
        # the reference's key_padding_mask/attn_mask modes are not carried:
        # padding here is handled structurally (pad_to_block_size + layouts),
        # which keeps the kernel mask-free and static
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        self._layouts: Dict[int, np.ndarray] = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def forward(self, query, key, value, *, causal: Optional[bool] = None,
                scale: Optional[float] = None):
        """query/key/value: [B, T, H, Dh] → [B, T, H, Dh]."""
        layout = self.get_layout(query.shape[1])
        if causal is None:
            causal = getattr(self.sparsity_config, "attention",
                             "bidirectional") == "unidirectional"
        return block_sparse_attention(
            query, key, value, layout, block=self.sparsity_config.block,
            causal=causal, scale=scale)

    @staticmethod
    def pad_to_block_size(block: int, input_ids, pad_token_id: int,
                          attention_mask=None):
        """Pad the sequence dim up to a block multiple (reference
        SparseAttentionUtils.pad_to_block_size). Returns (pad_len, padded
        ids, padded mask)."""
        pad = (-input_ids.shape[1]) % block
        if pad == 0:
            return 0, input_ids, attention_mask
        ids = F.pad(input_ids, (0, pad), value=pad_token_id)
        mask = None
        if attention_mask is not None:
            mask = F.pad(attention_mask, (0, pad), value=0)
        return pad, ids, mask

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        if pad_len == 0:
            return sequence_output
        return sequence_output[:, :-pad_len]
