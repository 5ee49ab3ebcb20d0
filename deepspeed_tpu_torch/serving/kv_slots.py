"""Slot-paged persistent KV cache for continuous batching (port of
deepspeed_tpu/serving/kv_slots.py).

One persistent ``[L, B_slots, Hkv, S_max, Dh]`` cache pair whose batch
dimension is the page table, plus a per-slot int32 ``lengths`` vector on
the device. Allocated once for the worst case and updated in place by the
serving programs; a finished request's slot is reused by the next prefill
with no reshaping. Every tensor keeps its address for the cache's life:
the decode program's CUDA graph reads them there. The port keeps the logical unpacked layout, so the
token-pair pack factor is always 1."""

from __future__ import annotations

from typing import Tuple

import torch

from deepspeed_tpu_torch.ops.decode_step import supports
from deepspeed_tpu_torch.serving.errors import EngineConfigError
from deepspeed_tpu_torch.serving.swap import to_host


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
        """Adopt a serving program's returned caches (the programs write in
        place and return them); ``lengths`` stays the same tensor."""
        self.k, self.v = k, v
        if lengths is not self.lengths:
            self.lengths.copy_(lengths)

    # ---------------------------------------------------------- programs
    # ``sample``: the serving engine's do_sample / top_k / top_p
    def prefill_program(self, engine, bucket: int, **sample):
        return engine.slot_prefill_program(bucket, self.num_slots,
                                           self.max_len, **sample)

    def chunk_program(self, engine, bucket: int, **sample):
        return engine.slot_chunk_prefill_program(bucket, self.num_slots,
                                                 self.max_len, **sample)

    def decode_program(self, engine, pad_token_id: int, **sample):
        return engine.slot_decode_program(self.num_slots, self.max_len,
                                          pad_token_id=pad_token_id, **sample)

    def verify_program(self, engine, k: int, pad_token_id: int, **sample):
        return engine.slot_verify_program(self.num_slots, self.max_len, k,
                                          pad_token_id=pad_token_id, **sample)

    def swap_programs(self, engine) -> Tuple:
        """The preemption swap-out and swap-in programs."""
        return (engine.slot_swap_out_program(self.num_slots, self.max_len),
                engine.slot_swap_in_program(self.num_slots, self.max_len))

    def prefill_args(self, slot: int, start: int, n: int) -> Tuple:
        """The prefill program's addressing operands after the ids: the slot
        and its new length (``start`` is 0: nothing is shared)."""
        return slot, start + n

    def chunk_args(self, slot: int, start: int, n: int) -> Tuple:
        """The chunk prefill's addressing operands after the ids."""
        return slot, start, n

    # -------------------------------------------------------------- swap
    def swap_out(self, fn, slot: int, length: int) -> Tuple:
        """Park slot ``slot``'s whole row on the host (the reference's swap
        unit, one page): ``(host_k, host_v, pages)``."""
        k_row, v_row = fn(self.k, self.v, slot)
        return to_host(k_row), to_host(v_row), 1

    def swap_in(self, fn, host_k, host_v, slot: int, length: int,
                shared: int = 0) -> int:
        """Write a parked row back into slot ``slot`` at length ``length``;
        returns the pages uploaded."""
        self.update(*fn(self.k, self.v, host_k, host_v, self.lengths, slot,
                        length))
        return 1

    def warm_swap(self, out_fn, in_fn) -> None:
        """Both swap programs once (slot 0 out and back, length 0)."""
        self.swap_in(in_fn, *self.swap_out(out_fn, 0, 0)[:2], 0, 0)

    def decode_args(self) -> Tuple:
        """The decode and verify programs' addressing operands: none beyond
        the carry."""
        return ()

    def decode_kernel_supports(self, num_heads: int) -> bool:
        """Whether the fused decode kernel takes this cache for a model with
        ``num_heads`` query heads."""
        _, _, hkv, s_max, dh = self.k.shape
        return supports(num_heads, hkv, s_max, dh, self.k.element_size())

    def capacity_for(self, prompt_len: int, max_new_tokens: int,
                     lookahead: int = 0) -> bool:
        """Whether one slot holds the request end to end (the last decode
        write lands at row prompt_len + max_new_tokens - 1). ``lookahead``
        reserves the rows a speculative verify writes before acceptance:
        the last verify, at length prompt_len + max_new_tokens - 1, writes
        up to k_max rows past it."""
        return prompt_len + max_new_tokens + lookahead <= self.max_len

    def hbm_bytes(self) -> int:
        return int(self.k.numel() * self.k.element_size()
                   + self.v.numel() * self.v.element_size())

    def __repr__(self):
        return (f"SlotKVCache(slots={self.num_slots}, max_len={self.max_len}, "
                f"bytes={self.hbm_bytes() / 1e6:.1f}MB)")
