"""Host-side KV swap buffer for preempted serving requests (port of
deepspeed_tpu/serving/swap.py).

Under pressure the serving engine swaps a lower-priority slot's KV out to
host memory, frees its slot or pool blocks for a higher-priority request,
and swaps it back in when the request resumes, bit-identical. The device
halves are the engine's swap programs over ops/attention's movers
(extract/insert_slot_kv, gather/scatter_pool_blocks); this module holds the
host side: one entry per request id with byte accounting, so the engine's
gauges can watch host-memory pressure.

The reference parks numpy arrays. numpy has neither bf16 nor
float8_e4m3fn, so the port parks torch tensors on the host, pinned when
they come from the card (:func:`to_host`): a pinned buffer takes the
device-to-host copy without staging, and uploads back without a sync.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.serving.errors import (EngineConfigError,
                                                KVLifecycleError,
                                                SwapCapacityError)
from deepspeed_tpu_torch.serving.kv_quant import tree_nbytes
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map


def to_host(tree, n_blocks: Optional[int] = None):
    """Copy a device tree (a slot row, or a ``[L, MB, ...]`` block gather
    trimmed to its first ``n_blocks`` blocks) into host tensors, pinned for a
    CUDA source, and wait for the copies: the caller frees the slot's blocks
    and may read the entry right after."""
    def copy(leaf):
        if n_blocks is not None:
            leaf = leaf[:, :n_blocks]
        host = torch.empty(leaf.shape, dtype=leaf.dtype,
                           pin_memory=leaf.is_cuda)
        host.copy_(leaf, non_blocking=True)
        return host

    out = tree_map(copy, tree)
    leaf = tree_leaves(tree)[0]
    if leaf.is_cuda:
        torch.cuda.current_stream(leaf.device).synchronize()
    return out


def to_device(tree, device, n_rows: Optional[int] = None):
    """Upload a host tree, zero-padded along its block axis to ``n_rows``
    (the swap-in program's fixed operand shape) when given. A pinned source
    uploads without a sync; the padding lands in the garbage row, which
    must stay finite."""
    def up(leaf):
        if n_rows is None:
            return leaf.to(device, non_blocking=True)
        out = torch.zeros((leaf.shape[0], n_rows) + tuple(leaf.shape[2:]),
                          dtype=leaf.dtype, device=device)
        out[:, :leaf.shape[1]].copy_(leaf, non_blocking=True)
        return out

    return tree_map(up, tree)


class HostSwapBuffer:
    """Host parking lot for preempted requests' KV rows or blocks.

    One entry per preempted request id: ``put`` on swap-out, ``pop`` on
    swap-in (single use: a resumed request's KV lives on the device again).
    Byte accounting covers exactly what is stored; ``peak_bytes`` is the
    high-water mark a deployment sizes its host reservation against.

    ``max_bytes`` caps the buffer: a ``put`` that would exceed it raises
    :class:`SwapCapacityError` before storing anything, so the engine
    declines the preemption and the candidate waits. ``None`` leaves it
    unbounded.
    """

    def __init__(self, max_bytes: Optional[int] = None):
        if max_bytes is not None and max_bytes <= 0:
            raise EngineConfigError(
                f"swap max_bytes must be positive or None, got {max_bytes}")
        self.max_bytes = max_bytes
        self._entries: Dict[int, Tuple] = {}
        self.bytes_stored = 0
        self.peak_bytes = 0
        self.total_swaps_out = 0
        self.total_swaps_in = 0
        self.capacity_rejections = 0

    def fits(self, nbytes: int) -> bool:
        """Would ``nbytes`` more fit under the cap right now?"""
        return (self.max_bytes is None
                or self.bytes_stored + nbytes <= self.max_bytes)

    def put(self, rid: int, k, v) -> None:
        """Park a preempted request's KV: host tensors (slot rows, block
        stacks) or quantized pools' ``{"q", "s"}`` trees of them."""
        if rid in self._entries:
            raise KVLifecycleError(
                f"request {rid} is already swapped out (double preemption "
                f"without a resume)")
        nbytes = tree_nbytes(k) + tree_nbytes(v)
        if not self.fits(nbytes):
            self.capacity_rejections += 1
            raise SwapCapacityError(
                f"host swap buffer full: {self.bytes_stored} bytes stored "
                f"+ {nbytes} requested exceeds max_bytes "
                f"{self.max_bytes} ({len(self._entries)} parked requests)")
        self._entries[rid] = (k, v)
        self.bytes_stored += nbytes
        self.peak_bytes = max(self.peak_bytes, self.bytes_stored)
        self.total_swaps_out += 1

    def discard(self, rid: int) -> bool:
        """Drop a parked entry without restoring it (a request cancelled
        while swapped out): frees its bytes, counts no swap-in. Returns
        False when nothing was parked."""
        entry = self._entries.pop(rid, None)
        if entry is None:
            return False
        self.bytes_stored -= tree_nbytes(entry[0]) + tree_nbytes(entry[1])
        return True

    def pop(self, rid: int) -> Tuple:
        if rid not in self._entries:
            raise KeyError(
                f"request {rid} has no swapped-out KV (resume without a "
                f"preemption, or a double resume)")
        k, v = self._entries.pop(rid)
        self.bytes_stored -= tree_nbytes(k) + tree_nbytes(v)
        self.total_swaps_in += 1
        return k, v

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self):
        return (f"HostSwapBuffer(entries={len(self._entries)}, "
                f"bytes={self.bytes_stored}, peak={self.peak_bytes})")
