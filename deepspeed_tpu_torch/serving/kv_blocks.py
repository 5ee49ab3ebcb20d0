"""Block-paged persistent KV pool for prefix-sharing serving (port of
deepspeed_tpu/serving/kv_blocks.py).

Instead of each slot owning one contiguous ``max_len`` region, the cache is
one pool of fixed-size token blocks ``[L, N+1, Hkv, bs, Dh]`` (the model's
stacked cache with the batch dim used as the block dim), and each slot's
logical KV space is a fixed-width block-table row ``[max_blocks_per_slot]``:
logical position ``p`` lives in pool block ``table[slot, p // bs]``, row
``p % bs``. Two slots whose prompts share a prefix name the same pool
blocks (serving/radix.py does the matching), and admission accounts in free
blocks, not contiguous rows.

Sentinel row: the pool allocates ``num_blocks + 1`` rows and keeps the last
one (index ``num_blocks``) as a garbage block that is never handed out.
Unallocated table entries name it, so inactive slots' writes land in (and
their reads come from) a row nobody owns, and logical positions past the
table width are written there too.

Host-side bookkeeping (free list, pin refcounts, the tables) is numpy; the
device sees the pool tensors, the per-slot lengths and the table, whose
persistent device buffer is refreshed in place only after a host-side
edit. Every device tensor keeps its address for the pool's life: the
decode program's CUDA graph reads them there.

With ``kv_dtype`` "int8" or "fp8" the pools are ``{"q": payload, "s":
scales}`` dicts (serving/kv_quant.py); the write paths quantize on store
and the read paths dequantize.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.decode_step import supports_block
from deepspeed_tpu_torch.serving.errors import (EngineConfigError,
                                                EngineInvariantError,
                                                KVLifecycleError)
from deepspeed_tpu_torch.serving.kv_quant import (normalize_kv_dtype,
                                                  pool_payload,
                                                  quantized_pool_like,
                                                  tree_nbytes)
from deepspeed_tpu_torch.serving.swap import to_device, to_host
from deepspeed_tpu_torch.utils.tree import tree_leaves


class BlockKVPool:
    """Owns the block pools, the per-slot lengths and the host-side block
    accounting (free list, pin refcounts, block tables).

    ``ref[b]`` counts running slots that name block ``b`` through the radix
    index (shared prefix blocks). A slot's private blocks are tracked by the
    PrefixCache's per-slot records; radix-cached blocks with ``ref == 0``
    are the LRU eviction pool. ``free_block`` refuses a pinned block."""

    def __init__(self, model, num_slots: int, max_len: int, *,
                 block_size: int = 16, num_blocks: int = None, dtype=None,
                 kv_dtype=None, device=None):
        if num_slots < 1:
            raise EngineConfigError(f"num_slots must be >= 1, got {num_slots}")
        if block_size < 1:
            raise EngineConfigError(f"block_size must be >= 1, got {block_size}")
        if max_len % block_size:
            raise EngineConfigError(
                f"max_len {max_len} must be a multiple of block_size "
                f"{block_size} (the block table is fixed-width)")
        self.block_size = block_size
        self.max_len = max_len
        self.num_slots = num_slots
        self.max_blocks_per_slot = max_len // block_size
        if num_blocks is None:
            # worst-case parity with SlotKVCache: every slot can hold a full
            # max_len request with nothing shared
            num_blocks = num_slots * self.max_blocks_per_slot
        if num_blocks < self.max_blocks_per_slot:
            raise EngineConfigError(
                f"num_blocks {num_blocks} below max_blocks_per_slot "
                f"{self.max_blocks_per_slot}: a single full-length request "
                f"could never be admitted")
        self.num_blocks = num_blocks
        self.sentinel = num_blocks          # the extra physical garbage row
        self.kv_dtype = normalize_kv_dtype(kv_dtype)
        self.device = torch.device(device) if device is not None else None
        if self.kv_dtype is not None:
            # the unquantized pool's shape, never allocated
            base = model.init_cache(num_blocks + 1, block_size, dtype=dtype,
                                    device="meta")["k"]
            self.k = quantized_pool_like(base, self.kv_dtype, device)
            self.v = quantized_pool_like(base, self.kv_dtype, device)
        else:
            base = model.init_cache(num_blocks + 1, block_size, dtype=dtype,
                                    device=device)
            self.k, self.v = base["k"], base["v"]
        self.lengths = torch.zeros((num_slots,), dtype=torch.int32,
                                   device=device)
        # host-side accounting
        self.tables = np.full((num_slots, self.max_blocks_per_slot),
                              self.sentinel, np.int32)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.ref = np.zeros((num_blocks,), np.int64)
        # device mirror, refreshed in place (see table_array())
        self._tables_dev = torch.from_numpy(self.tables.copy()).to(device)
        self._tables_stale = False

    # ------------------------------------------------------------- carry
    def carry(self) -> Tuple:
        """(k, v, lengths) operands for a serving program call (the block
        table rides separately, see :meth:`table_array`)."""
        return self.k, self.v, self.lengths

    def update(self, k, v, lengths) -> None:
        """Adopt a serving program's returned pools (written in place);
        ``lengths`` stays the same tensor."""
        self.k, self.v = k, v
        if lengths is not self.lengths:
            self.lengths.copy_(lengths)

    def update_kv(self, k, v) -> None:
        self.k, self.v = k, v

    def table_array(self) -> torch.Tensor:
        """The full ``[num_slots, MB]`` int32 block table on the device: one
        persistent buffer, copied from the host tables only after they
        changed (at admit/finish, PrefixCache calls
        :meth:`invalidate_tables`), so decode steps reuse one upload."""
        if self._tables_stale:
            self._tables_dev.copy_(torch.from_numpy(self.tables))
            self._tables_stale = False
        return self._tables_dev

    def invalidate_tables(self) -> None:
        """Mark the device mirror stale after a host-side table edit."""
        self._tables_stale = True

    def table_row(self, slot: int) -> torch.Tensor:
        """One slot's ``[1, MB]`` table row (the suffix prefill's
        addressing operand)."""
        return torch.from_numpy(self.tables[slot:slot + 1].copy()).to(
            self.device)

    # ---------------------------------------------------------- programs
    # ``sample``: the serving engine's do_sample / top_k / top_p. A chunk of
    # a prompt runs the suffix prefill from its offset: no program of its own
    def prefill_program(self, engine, bucket: int, **sample):
        return engine.block_prefill_program(bucket, self.num_slots,
                                            self.max_blocks_per_slot,
                                            kv_dtype=self.kv_dtype, **sample)

    def copy_program(self, engine):
        return engine.block_copy_program(self.num_blocks, self.block_size,
                                         kv_dtype=self.kv_dtype or "compute")

    def decode_program(self, engine, pad_token_id: int, **sample):
        return engine.block_decode_program(self.num_slots,
                                           self.max_blocks_per_slot,
                                           pad_token_id=pad_token_id,
                                           kv_dtype=self.kv_dtype, **sample)

    def verify_program(self, engine, k: int, pad_token_id: int, **sample):
        return engine.block_verify_program(self.num_slots,
                                           self.max_blocks_per_slot, k,
                                           pad_token_id=pad_token_id,
                                           kv_dtype=self.kv_dtype, **sample)

    def swap_programs(self, engine) -> Tuple:
        """The preemption swap-out and swap-in programs."""
        kw = dict(kv_dtype=self.kv_dtype or "compute")
        return (engine.block_swap_out_program(self.num_blocks,
                                              self.max_blocks_per_slot, **kw),
                engine.block_swap_in_program(self.num_blocks,
                                             self.max_blocks_per_slot, **kw))

    def prefill_args(self, slot: int, start: int, n: int) -> Tuple:
        """The suffix prefill's addressing operands after the ids: the
        slot's table row, the slot, the matched length ``start`` and the
        suffix length ``n``."""
        return self.table_row(slot), slot, start, n

    def decode_args(self) -> Tuple:
        """The decode and verify programs' addressing operand: the full
        block table (see :meth:`table_array`)."""
        return (self.table_array(),)

    def decode_kernel_supports(self, num_heads: int) -> bool:
        """Whether the block decode kernel takes this pool for a model with
        ``num_heads`` query heads."""
        payload = pool_payload(self.k)
        _, _, hkv, bs, dh = payload.shape
        return supports_block(num_heads, hkv, bs, dh, payload.element_size())

    # -------------------------------------------------------------- swap
    def _row(self, entries) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(entries, np.int32)).to(
            self.device)

    def swap_out(self, fn, slot: int, length: int) -> Tuple:
        """Park the blocks slot ``slot`` computed into (``length`` tokens:
        payload and scales of a quantized pool, the stored bytes) on the
        host: ``(host_k, host_v, blocks)``. The caller frees the blocks."""
        n_used = self.blocks_for(length)
        k_blk, v_blk = fn(self.k, self.v, self._row(self.tables[slot]))
        return to_host(k_blk, n_used), to_host(v_blk, n_used), n_used

    def swap_in(self, fn, host_k, host_v, slot: int, length: int,
                shared: int = 0) -> int:
        """Write parked blocks back through slot ``slot``'s (rebuilt) table
        row at length ``length``, skipping its first ``shared`` blocks (the
        radix index re-pinned them: the same tokens at the same positions).
        Returns the blocks uploaded."""
        mb = self.max_blocks_per_slot
        n_used = tree_leaves(host_k)[0].shape[1]
        dst = np.full((mb,), self.sentinel, np.int32)
        dst[shared:n_used] = self.tables[slot][shared:n_used]
        up_k = to_device(host_k, self.device, mb)
        up_v = to_device(host_v, self.device, mb)
        self.update(*fn(self.k, self.v, up_k, up_v, self._row(dst),
                        self.lengths, slot, length))
        return max(n_used - shared, 0)

    def warm_swap(self, out_fn, in_fn) -> None:
        """Both swap programs once, through a sentinel row: every write
        lands in the garbage row."""
        sent = self._row(np.full((self.max_blocks_per_slot,), self.sentinel))
        k_blk, v_blk = out_fn(self.k, self.v, sent)
        self.update(*in_fn(self.k, self.v, to_device(to_host(k_blk),
                                                     self.device),
                           to_device(to_host(v_blk), self.device), sent,
                           self.lengths, 0, 0))

    # ------------------------------------------------------------ blocks
    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc_block(self) -> int:
        if not self._free:
            raise EngineInvariantError(
                "block pool exhausted (admission should have evicted or "
                "deferred: this is a bug)")
        return self._free.pop()

    def free_block(self, block: int) -> None:
        if self.ref[block] != 0:
            raise KVLifecycleError(
                f"freeing block {block} with refcount {self.ref[block]} "
                f"(still pinned by a running slot)")
        self._free.append(block)

    def pin(self, block: int) -> None:
        self.ref[block] += 1

    def unpin(self, block: int) -> None:
        if self.ref[block] <= 0:
            raise KVLifecycleError(f"unpin of unpinned block {block}")
        self.ref[block] -= 1

    # ------------------------------------------------------------ sizing
    def capacity_for(self, prompt_len: int, max_new_tokens: int,
                     lookahead: int = 0) -> bool:
        """Whether the fixed-width block table holds the request end to end
        (prompt + every generated token + the speculative lookahead, as
        SlotKVCache.capacity_for, rounded up to whole blocks)."""
        return (self.blocks_for(prompt_len + max_new_tokens + lookahead)
                <= self.max_blocks_per_slot)

    def hbm_bytes(self) -> int:
        """Pool bytes, scales included for quantized pools."""
        return tree_nbytes(self.k) + tree_nbytes(self.v)

    def blocks_per_mib(self) -> float:
        """Real (non-sentinel) pool blocks per MiB of pool memory: the
        capacity lever kv_dtype buys."""
        return self.num_blocks / max(self.hbm_bytes() / (1 << 20), 1e-12)

    def occupancy(self) -> float:
        """Fraction of real pool blocks handed out (running slots' blocks +
        radix-cached blocks)."""
        return 1.0 - len(self._free) / max(self.num_blocks, 1)

    def __repr__(self):
        return (f"BlockKVPool(blocks={self.num_blocks}x{self.block_size}t, "
                f"slots={self.num_slots}, mb={self.max_blocks_per_slot}, "
                f"kv_dtype={self.kv_dtype or 'compute'}, "
                f"bytes={self.hbm_bytes() / 1e6:.1f}MB)")
