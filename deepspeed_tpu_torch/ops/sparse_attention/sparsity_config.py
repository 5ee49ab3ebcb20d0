"""Sparsity structure configs → block-level attention layouts (port of
deepspeed_tpu/ops/sparse_attention/sparsity_config.py).

Each config emits a boolean block layout ``[num_heads, nb, nb]`` (nb =
seq_len // block) marking which [block × block] tiles of the attention
matrix are computed. Layouts are static numpy, bit-identical to the JAX
package's: they are a shape decision made on the host (the LUTs of the
block-sparse kernels are built from them), not sampled data, so BigBird's
and Variable's random blocks come from ``np.random.RandomState(seed)`` as
in the reference, not from a torch generator.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: dense layout (reference SparsityConfig.setup_layout builds the
    all-zero layout; subclasses set blocks)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} must be divisible by "
                             f"block {self.block}")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), dtype=bool)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[...] = True
        return layout

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0:1]
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks active (reference DenseSparsityConfig)."""


class FixedSparsityConfig(SparsityConfig):
    """Fixed local+global pattern (reference FixedSparsityConfig:95):
    each query block attends to its local window of ``num_local_blocks``
    and to ``num_global_blocks`` global summary blocks chosen per head from
    the end of each local window (unidirectional) — with optional
    horizontal global attention for bidirectional models."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError("num_local_blocks must be divisible by "
                             "num_global_blocks")
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention '{attention}'")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("different global patterns require "
                             "different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError("num_different_global_patterns is limited by "
                             "num_local_blocks // num_global_blocks")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        for h in range(self.num_heads):
            # local windows
            for start in range(0, nb, self.num_local_blocks):
                end = min(start + self.num_local_blocks, nb)
                for q in range(start, end):
                    hi = (q + 1) if self.attention == "unidirectional" else end
                    layout[h, q, start:hi] = True
            # global blocks: head (or first) pattern picks which slot of the
            # local window acts as global summary
            pattern = h % self.num_different_global_patterns \
                if self.different_layout_per_head else 0
            first_global = self.num_local_blocks - \
                (pattern + 1) * self.num_global_blocks
            for wstart in range(0, nb, self.num_local_blocks):
                g0 = wstart + first_global
                g1 = g0 + self.num_global_blocks
                if g1 > nb:
                    continue
                # vertical: every later query block sees the globals
                qlo = wstart if self.attention == "bidirectional" else g1
                layout[h, qlo:, g0:g1] = True
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones_like(layout[0]))[None]
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local windows + explicit global blocks + random blocks
    (reference VariableSparsityConfig:265)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        if self.global_block_end_indices is not None and \
                len(self.global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global_block_end_indices must pair with "
                             "global_block_indices")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        rng = np.random.RandomState(self.seed)
        for h in range(self.num_heads):
            # local variable-size windows, cycling the provided sizes
            start = 0
            w = 0
            while start < nb:
                size = self.local_window_blocks[
                    min(w, len(self.local_window_blocks) - 1)]
                end = min(start + size, nb)
                for q in range(start, end):
                    hi = (q + 1) if self.attention == "unidirectional" else end
                    layout[h, q, start:hi] = True
                start, w = end, w + 1
            # globals
            for i, g in enumerate(self.global_block_indices):
                if g >= nb:
                    continue
                g1 = min(self.global_block_end_indices[i],
                         nb) if self.global_block_end_indices else g + 1
                qlo = 0 if self.attention == "bidirectional" else g1
                layout[h, qlo:, g:g1] = True
                if self.horizontal_global_attention:
                    layout[h, g:g1, :] = True
            # random blocks
            for q in range(nb):
                for g in rng.choice(nb, size=self.num_random_blocks,
                                    replace=False) if self.num_random_blocks else []:
                    layout[h, q, g] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones_like(layout[0]))[None]
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding window + global (reference
    BigBirdSparsityConfig:438)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1, num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, attention: str = "bidirectional",
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        rng = np.random.RandomState(self.seed)
        for h in range(self.num_heads):
            for q in range(nb):
                layout[h, q, max(0, q - w):min(nb, q + w + 1)] = True  # window
                rand = rng.choice(nb, size=min(self.num_random_blocks, nb),
                                  replace=False)
                layout[h, q, rand] = True                              # random
            g = min(self.num_global_blocks, nb)
            layout[h, :, :g] = True                                    # global cols
            layout[h, :g, :] = True                                    # global rows
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones_like(layout[0]))[None]
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + chosen global blocks
    (reference BSLongformerSparsityConfig:532)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads):
            for q in range(nb):
                layout[h, q, max(0, q - w):min(nb, q + w + 1)] = True
            for i, g in enumerate(self.global_block_indices):
                if g >= nb:
                    continue
                g1 = min(self.global_block_end_indices[i],
                         nb) if self.global_block_end_indices else g + 1
                layout[h, :, g:g1] = True  # global columns
                layout[h, g:g1, :] = True  # global rows
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones_like(layout[0]))[None]
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding window (reference LocalSlidingWindowSparsityConfig:632)."""

    def __init__(self, num_heads: int, block: int = 16,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for q in range(nb):
            if self.attention == "unidirectional":
                lo = max(0, q - self.num_sliding_window_blocks + 1)
                layout[:, q, lo:q + 1] = True
            else:
                layout[:, q, max(0, q - w):min(nb, q + w + 1)] = True
        return layout
