"""Optimizer state on fast storage (ZeRO-Infinity; port of
deepspeed_tpu/runtime/swap_tensor/optimizer_swapper.py, the reference's
OptimizerSwapper and PipelinedOptimizerSwapper).

Each sub-group's state (the f32 master and its moments, a dict of host
tensors) lives on storage. ``OptimizerSwapper`` swaps a group in and out
synchronously; ``PipelinedOptimizerSwapper.run_step`` overlaps them around
each group's host step:

    swap_in(group i+1)   async prefetch   | overlapped with
    step on group i                       | the host kernel
    swap_out(group i)    async write-back |
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import AsyncTensorSwapper


class OptimizerSwapper:
    def __init__(self, swap_folder: str, aio_handle=None):
        self.swapper = AsyncTensorSwapper(os.path.join(swap_folder, "optimizer"),
                                          aio_handle=aio_handle)

    def _key(self, group: int, name: str) -> str:
        return f"group{group}__{name}"

    def swap_out_group(self, group: int, state: Dict[str, torch.Tensor],
                       async_op: bool = False) -> None:
        for name, t in state.items():
            self.swapper.swap_out(self._key(group, name), t, async_op=True)
        if not async_op:
            self.swapper.synchronize()

    def swap_in_group(self, group: int, names: List[str],
                      async_op: bool = False
                      ) -> Optional[Dict[str, torch.Tensor]]:
        for name in names:
            self.swapper.swap_in(self._key(group, name), async_op=True)
        if async_op:
            return None
        return self.wait_group(group, names)

    def wait_group(self, group: int, names: List[str]) -> Dict[str, torch.Tensor]:
        return {name: self.swapper.wait_in(self._key(group, name))
                for name in names}

    def synchronize(self) -> None:
        self.swapper.synchronize()

    def contains_group(self, group: int, name: str) -> bool:
        return self.swapper.contains(self._key(group, name))


class PipelinedOptimizerSwapper(OptimizerSwapper):
    """The read / step / write-back overlap over sub-groups (the
    reference's pipeline_read / pipeline_write)."""

    def run_step(self, groups: List[int], state_names: List[str], step_fn):
        """For each group g in order, ``step_fn(g, state)`` updates the
        group's swapped-in state in place; its write-back and the next
        group's read overlap the step."""
        if not groups:
            return
        self.swap_in_group(groups[0], state_names, async_op=True)
        resident = self.wait_group(groups[0], state_names)
        for i, g in enumerate(groups):
            nxt = groups[i + 1] if i + 1 < len(groups) else None
            if nxt is not None:
                self.swap_in_group(nxt, state_names, async_op=True)
            step_fn(g, resident)
            self.swap_out_group(g, resident, async_op=True)
            if nxt is not None:
                resident = self.wait_group(nxt, state_names)
        self.synchronize()
