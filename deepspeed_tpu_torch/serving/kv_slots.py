"""Slot-paged persistent KV cache for continuous batching (port of
deepspeed_tpu/serving/kv_slots.py).

One persistent ``[L, B_slots, Hkv, S_max, Dh]`` cache pair whose batch
dimension is the page table, plus a per-slot int32 ``lengths`` vector on
the device. Allocated once for the worst case and updated in place by the
serving programs; a finished request's slot is reused by the next prefill
with no reshaping. The port keeps the logical unpacked layout, so the
token-pair pack factor is always 1."""

from __future__ import annotations

from typing import Tuple

import torch

from deepspeed_tpu_torch.serving.errors import EngineConfigError


class SlotKVCache:
    """Owns the persistent slot cache tensors and the per-slot lengths."""

    pair = 1

    def __init__(self, model, num_slots: int, max_len: int, dtype=None,
                 device=None):
        if num_slots < 1:
            raise EngineConfigError(f"num_slots must be >= 1, got {num_slots}")
        base = model.init_cache(num_slots, max_len, dtype=dtype, device=device)
        self.k = base["k"]
        self.v = base["v"]
        self.lengths = torch.zeros((num_slots,), dtype=torch.int32,
                                   device=device)
        self.num_slots = num_slots
        self.max_len = max_len

    def carry(self) -> Tuple:
        """(k, v, lengths) operands for a serving program call."""
        return self.k, self.v, self.lengths

    def update(self, k, v, lengths) -> None:
        """Adopt a serving program's returned tensors."""
        self.k, self.v, self.lengths = k, v, lengths

    def capacity_for(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Whether one slot holds the request end to end (the last decode
        write lands at row prompt_len + max_new_tokens - 1)."""
        return prompt_len + max_new_tokens <= self.max_len

    def hbm_bytes(self) -> int:
        return int(self.k.numel() * self.k.element_size()
                   + self.v.numel() * self.v.element_size())

    def __repr__(self):
        return (f"SlotKVCache(slots={self.num_slots}, max_len={self.max_len}, "
                f"bytes={self.hbm_bytes() / 1e6:.1f}MB)")
