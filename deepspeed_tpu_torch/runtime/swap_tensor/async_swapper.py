"""Async tensor swapping (port of
deepspeed_tpu/runtime/swap_tensor/async_swapper.py; the reference's
AsyncTensorSwapper): each named host tensor maps to one file under the swap
folder, written and read back through the native async IO engine without
blocking the caller until it asks."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch


@dataclass
class _Inflight:
    request_id: int
    buffer: torch.Tensor
    write: bool


class AsyncTensorSwapper:
    def __init__(self, swap_folder: str, aio_handle=None, num_threads: int = 8,
                 block_size: int = 1 << 20):
        os.makedirs(swap_folder, exist_ok=True)
        self.swap_folder = swap_folder
        if aio_handle is None:
            from deepspeed_tpu_torch.ops.aio import AsyncIOHandle

            aio_handle = AsyncIOHandle(block_size=block_size,
                                       num_threads=num_threads)
        self.aio = aio_handle
        self._inflight: Dict[str, _Inflight] = {}
        self._meta: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        self.num_elements_swapped = 0       # the reference's accounting
        self.bytes_written = 0
        self.bytes_read = 0

    def _path(self, name: str) -> str:
        return os.path.join(self.swap_folder, name.replace("/", "__") + ".swp")

    def swap_out(self, name: str, tensor: torch.Tensor,
                 async_op: bool = True) -> None:
        """Write ``tensor``; it must stay alive and unchanged until
        synchronize() when async."""
        self.synchronize(name)              # a pending op on this name first
        tensor = tensor.contiguous()
        self._meta[name] = (tuple(tensor.shape), tensor.dtype)
        rid = self.aio.async_pwrite(tensor, self._path(name))
        self._inflight[name] = _Inflight(rid, tensor, write=True)
        self.num_elements_swapped += tensor.numel()
        self.bytes_written += tensor.numel() * tensor.element_size()
        if not async_op:
            self.synchronize(name)

    def swap_in(self, name: str, async_op: bool = True,
                out: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """Read the named tensor back (into ``out`` when given). With
        ``async_op`` it returns None and wait_in() claims the result."""
        assert name in self._meta, f"'{name}' was never swapped out"
        self.synchronize(name)              # a pending write completes first
        shape, dtype = self._meta[name]
        buf = out if out is not None else torch.empty(shape, dtype=dtype)
        rid = self.aio.async_pread(buf, self._path(name))
        self._inflight[name] = _Inflight(rid, buf, write=False)
        self.bytes_read += buf.numel() * buf.element_size()
        if async_op:
            return None
        return self.wait_in(name)

    def wait_in(self, name: str) -> torch.Tensor:
        fl = self._inflight.pop(name)
        assert not fl.write, f"wait_in('{name}') on a swap-out request"
        self.aio.wait(fl.request_id)
        return fl.buffer

    def synchronize(self, name: Optional[str] = None) -> None:
        """Complete one named request, or all in flight."""
        if name is not None:
            fl = self._inflight.pop(name, None)
            if fl is not None:
                self.aio.wait(fl.request_id)
            return
        for n in list(self._inflight):
            self.synchronize(n)

    def contains(self, name: str) -> bool:
        return name in self._meta

    def meta(self, name: str) -> Tuple[Tuple[int, ...], torch.dtype]:
        """(shape, dtype) of a swapped-out tensor."""
        assert name in self._meta, f"'{name}' was never swapped out"
        return self._meta[name]

    def release(self, name: str) -> None:
        self.synchronize(name)
        self._meta.pop(name, None)
        try:
            os.remove(self._path(name))
        except OSError:
            pass
