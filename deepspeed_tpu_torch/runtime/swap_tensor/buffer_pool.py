"""Reusable host swap buffers (port of
deepspeed_tpu/runtime/swap_tensor/buffer_pool.py; the reference's
SwapBufferPool / SwapBufferManager): a fixed count of fixed-size buffers
checked out and back in, so steady-state swapping allocates nothing.

The IO engine (csrc/aio/dstpu_aio.cpp) opens its files without
``O_DIRECT``, so it needs no buffer alignment and any contiguous
``torch.empty`` would do; the pool's buffers are page-aligned all the same,
as the reference's are, so an ``O_DIRECT`` engine could take them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

ALIGNMENT = 4096


def aligned_empty(nbytes: int, dtype=torch.uint8) -> torch.Tensor:
    """A page-aligned 1-D host buffer of ``nbytes`` bytes viewed as ``dtype``
    (``nbytes`` a multiple of its size)."""
    raw = torch.empty(nbytes + ALIGNMENT, dtype=torch.uint8)
    off = (-raw.data_ptr()) % ALIGNMENT
    return raw[off:off + nbytes].view(dtype)


class SwapBufferPool:
    """``count`` buffers of ``buffer_size_bytes`` each, with get / put."""

    def __init__(self, buffer_size_bytes: int, count: int):
        self.buffer_size = int(buffer_size_bytes)
        self._free: List[torch.Tensor] = [aligned_empty(self.buffer_size)
                                          for _ in range(count)]
        self._used: Dict[int, torch.Tensor] = {}

    def available(self) -> int:
        return len(self._free)

    def get(self, nbytes: int) -> Optional[torch.Tensor]:
        """A uint8 view of exactly ``nbytes`` of a free buffer; None when
        the pool is empty or the request is larger than a buffer (the
        caller then allocates one of its own)."""
        if nbytes > self.buffer_size or not self._free:
            return None
        buf = self._free.pop()
        self._used[buf.data_ptr()] = buf
        return buf[:nbytes]

    def put(self, view: torch.Tensor) -> None:
        # a checked-out view starts at its buffer's first byte, whatever
        # dtype or shape it was viewed as since
        buf = self._used.pop(view.data_ptr(), None)
        if buf is not None:
            self._free.append(buf)
