"""Mixed precision: loss scaling and grad checks (port of
deepspeed_tpu/runtime/precision.py) — analog of reference
``deepspeed/runtime/fp16/loss_scaler.py``.

The scaler state is the reference's four fields, held on the host as plain
numbers (the loss scale as the f32 value the reference keeps). The engine
reads the overflow flag to the host once per step when it needs it (fp16,
or the finite-grad guard) and skips the update there; ``update`` applies
the reference's on-overflow / on-ok rules, hysteresis included. The grad
reductions run on the grads' device and return 0-d tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map


def _f32(x) -> float:
    return float(np.float32(x))


class LossScalerState(NamedTuple):
    cur_scale: float            # an f32 value
    cur_iter: int
    last_overflow_iter: int
    cur_hysteresis: int


@dataclasses.dataclass
class DynamicLossScaler:
    init_scale: float = 2.0 ** 16
    scale_factor: float = 2.0
    scale_window: int = 1000
    min_scale: float = 1.0
    delayed_shift: int = 1  # hysteresis

    def init(self) -> LossScalerState:
        return LossScalerState(cur_scale=_f32(self.init_scale), cur_iter=0,
                               last_overflow_iter=-1,
                               cur_hysteresis=int(self.delayed_shift))

    def update(self, state: LossScalerState, has_overflow: bool) -> LossScalerState:
        if has_overflow:
            new_hyst = state.cur_hysteresis - 1
            drop = new_hyst <= 0
            scale = state.cur_scale
            if drop:
                scale = max(_f32(scale / self.scale_factor), _f32(self.min_scale))
            return LossScalerState(
                cur_scale=scale, cur_iter=state.cur_iter + 1,
                last_overflow_iter=state.cur_iter,
                cur_hysteresis=int(self.delayed_shift) if drop else new_hyst)
        grow = ((state.cur_iter - state.last_overflow_iter) % self.scale_window
                == self.scale_window - 1)
        return state._replace(
            cur_scale=_f32(state.cur_scale * self.scale_factor) if grow
            else state.cur_scale,
            cur_iter=state.cur_iter + 1)


@dataclasses.dataclass
class StaticLossScaler:
    scale: float = 1.0

    def init(self) -> LossScalerState:
        return LossScalerState(cur_scale=_f32(self.scale), cur_iter=0,
                               last_overflow_iter=-1, cur_hysteresis=1)

    def update(self, state: LossScalerState, has_overflow: bool) -> LossScalerState:
        return state._replace(cur_iter=state.cur_iter + 1)


def create_loss_scaler(fp16_config) -> Any:
    """Mirror of CREATE_LOSS_SCALER logic (reference fp16/loss_scaler.py)."""
    if fp16_config.loss_scale and fp16_config.loss_scale > 0:
        return StaticLossScaler(scale=float(fp16_config.loss_scale))
    return DynamicLossScaler(
        init_scale=2.0 ** fp16_config.initial_scale_power,
        scale_window=fp16_config.loss_scale_window,
        min_scale=fp16_config.min_loss_scale,
        delayed_shift=fp16_config.hysteresis,
    )


def has_inf_or_nan(tree) -> torch.Tensor:
    """Global overflow flag of a grad tree, a 0-d bool tensor."""
    flags = [~torch.isfinite(x).all() for x in tree_leaves(tree)]
    return torch.stack(flags).any()


def global_grad_norm(tree) -> torch.Tensor:
    """L2 norm over a grad tree in f32 (leaf sums added in tree order)."""
    total = None
    for x in tree_leaves(tree):
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_grads_by_global_norm(tree, max_norm: float, norm: torch.Tensor = None):
    """clip_grad_norm_ analog; returns ``(clipped, norm)``."""
    if norm is None:
        norm = global_grad_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm
