"""Parameter partitions on fast storage (port of
deepspeed_tpu/runtime/swap_tensor/partitioned_param_swapper.py; the
reference's AsyncPartitionedParameterSwapper): each shard can live on
storage instead of in memory, prefetched into pooled buffers ahead of use
and released after. The swapper keeps each shard's status by name. As in
the reference, the engine does not use it: nothing outside swap_tensor/
does (``offload_param`` is parsed and not read)."""

from __future__ import annotations

import os
from enum import Enum
from typing import Dict, Iterable

import torch

from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import AsyncTensorSwapper
from deepspeed_tpu_torch.runtime.swap_tensor.buffer_pool import SwapBufferPool


class PartitionedParamStatus(Enum):
    AVAILABLE = 1       # in host memory
    NOT_AVAILABLE = 2   # on storage only
    INFLIGHT = 3        # a read submitted, not complete


class AsyncPartitionedParameterSwapper:
    def __init__(self, swap_folder: str, buffer_count: int = 5,
                 buffer_size: int = int(1e8), aio_handle=None):
        self.swapper = AsyncTensorSwapper(os.path.join(swap_folder, "params"),
                                          aio_handle=aio_handle)
        self.pool = SwapBufferPool(buffer_size, buffer_count)
        self.status: Dict[str, PartitionedParamStatus] = {}
        self._resident: Dict[str, torch.Tensor] = {}
        self._pooled: Dict[str, bool] = {}

    # -- write path
    def swap_out_and_release(self, name: str, shard: torch.Tensor,
                             async_op: bool = True) -> None:
        """Persist a shard and drop it from memory (at once, or at
        synchronize_writes() when async)."""
        self.swapper.swap_out(name, shard, async_op=async_op)
        if not async_op:
            self._drop(name)
        self.status[name] = PartitionedParamStatus.NOT_AVAILABLE

    def synchronize_writes(self) -> None:
        self.swapper.synchronize()
        for name, st in list(self.status.items()):
            if st == PartitionedParamStatus.NOT_AVAILABLE:
                self._drop(name)

    # -- read path
    def swap_in(self, names: Iterable[str], async_op: bool = True) -> None:
        """Submit reads of the shards not already in memory or in flight."""
        for name in names:
            if self.status.get(name) in (PartitionedParamStatus.AVAILABLE,
                                         PartitionedParamStatus.INFLIGHT):
                continue
            self._drop(name)        # recycle a stale resident buffer first
            shape, dtype = self.swapper.meta(name)
            itemsize = torch.empty((), dtype=dtype).element_size()
            numel = 1
            for d in shape:
                numel *= d
            buf = self.pool.get(numel * itemsize)
            out = buf.view(dtype).view(shape) if buf is not None else None
            self.swapper.swap_in(name, async_op=True, out=out)
            self.status[name] = PartitionedParamStatus.INFLIGHT
            self._pooled[name] = buf is not None
        if not async_op:
            self.synchronize_reads()

    def synchronize_reads(self) -> None:
        for name in list(self.status):
            self._complete_inflight(name)

    def get(self, name: str) -> torch.Tensor:
        """The host tensor of a shard (waits for its read if in flight)."""
        self._complete_inflight(name)
        assert self.status.get(name) == PartitionedParamStatus.AVAILABLE, \
            f"shard '{name}' is not resident (status={self.status.get(name)})"
        return self._resident[name]

    def release(self, name: str) -> None:
        """Drop a shard from memory; storage keeps it."""
        self._complete_inflight(name)
        self._drop(name)
        if self.swapper.contains(name):
            self.status[name] = PartitionedParamStatus.NOT_AVAILABLE

    def remove(self, name: str) -> None:
        """Forget a shard in memory and on storage."""
        self._complete_inflight(name)
        self._drop(name)
        self.swapper.release(name)
        self.status.pop(name, None)

    def available_swap_in_buffers(self) -> int:
        return self.pool.available()

    def _complete_inflight(self, name: str) -> None:
        if self.status.get(name) == PartitionedParamStatus.INFLIGHT:
            self._resident[name] = self.swapper.wait_in(name)
            self.status[name] = PartitionedParamStatus.AVAILABLE

    def _drop(self, name: str) -> None:
        t = self._resident.pop(name, None)
        if t is not None and self._pooled.pop(name, False):
            self.pool.put(t)
