"""The async file IO engine (port of deepspeed_tpu/ops/aio.py) over
csrc/aio/dstpu_aio.cpp, built by ``ops/native/builder.py``.

``AsyncIOHandle`` has the reference's surface: ``async_pread`` /
``async_pwrite`` return a request id, ``wait(id)`` or ``wait()`` (all
in flight) complete them, ``sync_pread`` / ``sync_pwrite`` block, and the
introspection calls read the engine's settings. Buffers are contiguous
torch CPU tensors (any dtype, their bytes); an async request's buffer must
stay alive until its wait. The engine opens files without ``O_DIRECT``, so
a buffer needs no alignment. Used by ``runtime/swap_tensor`` for
ZeRO-Infinity's optimizer swap.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

_LIB: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from deepspeed_tpu_torch.ops import AsyncIOBuilder

        lib = AsyncIOBuilder().load_library()
        lib.dstpu_aio_create.restype = ctypes.c_void_p
        lib.dstpu_aio_create.argtypes = [ctypes.c_uint64, ctypes.c_int,
                                         ctypes.c_int]
        lib.dstpu_aio_destroy.argtypes = [ctypes.c_void_p]
        io = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
              ctypes.c_uint64, ctypes.c_uint64]
        for fn in (lib.dstpu_aio_pread, lib.dstpu_aio_pwrite):
            fn.restype, fn.argtypes = ctypes.c_int64, io
        for fn in (lib.dstpu_aio_sync_pread, lib.dstpu_aio_sync_pwrite):
            fn.restype, fn.argtypes = ctypes.c_int, io
        lib.dstpu_aio_wait.restype = ctypes.c_int
        lib.dstpu_aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        for name, res in (("dstpu_aio_wait_all", ctypes.c_int),
                          ("dstpu_aio_block_size", ctypes.c_uint64),
                          ("dstpu_aio_queue_depth", ctypes.c_int),
                          ("dstpu_aio_thread_count", ctypes.c_int)):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _as_buffer(t: torch.Tensor):
    assert t.device.type == "cpu", "aio reads and writes host tensors"
    assert t.is_contiguous(), "aio requires contiguous buffers"
    return t.data_ptr(), t.numel() * t.element_size()


class AsyncIOHandle:
    """The reference's ``aio_handle``: a pool of IO threads and a request
    queue; each request is split into ``block_size`` chunks over the pool."""

    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 32,
                 single_submit: bool = False, overlap_events: bool = True,
                 num_threads: int = 8):
        self._lib = load()
        self._h = self._lib.dstpu_aio_create(block_size, queue_depth,
                                             num_threads)
        if not self._h:
            raise RuntimeError("failed to create the aio engine")
        # kept for the reference's config surface
        self.single_submit = single_submit
        self.overlap_events = overlap_events

    def get_block_size(self) -> int:
        return self._lib.dstpu_aio_block_size(self._h)

    def get_queue_depth(self) -> int:
        return self._lib.dstpu_aio_queue_depth(self._h)

    def get_thread_count(self) -> int:
        return self._lib.dstpu_aio_thread_count(self._h)

    def _submit(self, fn, buffer, filename: str, offset: int, what: str) -> int:
        ptr, nbytes = _as_buffer(buffer)
        rid = fn(self._h, os.fsencode(filename), ptr, nbytes, offset)
        if rid < 0:
            raise OSError(-rid, f"aio {what} failed for {filename}")
        return rid

    def async_pread(self, buffer: torch.Tensor, filename: str,
                    offset: int = 0) -> int:
        return self._submit(self._lib.dstpu_aio_pread, buffer, filename,
                            offset, "pread submit")

    def async_pwrite(self, buffer: torch.Tensor, filename: str,
                     offset: int = 0) -> int:
        return self._submit(self._lib.dstpu_aio_pwrite, buffer, filename,
                            offset, "pwrite submit")

    def wait(self, request_id: Optional[int] = None) -> int:
        """Wait for one request (0), or for all in flight (their count)."""
        rc = (self._lib.dstpu_aio_wait_all(self._h) if request_id is None
              else self._lib.dstpu_aio_wait(self._h, request_id))
        if rc < 0:
            raise OSError(-rc, "aio request failed")
        return rc

    def sync_pread(self, buffer: torch.Tensor, filename: str,
                   offset: int = 0) -> None:
        self._submit(self._lib.dstpu_aio_sync_pread, buffer, filename, offset,
                     "sync pread")

    def sync_pwrite(self, buffer: torch.Tensor, filename: str,
                    offset: int = 0) -> None:
        self._submit(self._lib.dstpu_aio_sync_pwrite, buffer, filename,
                     offset, "sync pwrite")

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.dstpu_aio_destroy(self._h)
                self._h = None
        except Exception:
            pass
