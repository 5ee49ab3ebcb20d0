"""LR schedules (copy of deepspeed_tpu/runtime/lr_schedules.py for the
PyTorch port) — analog of reference ``deepspeed/runtime/lr_schedules.py``
(WarmupLR, WarmupDecayLR, WarmupCosineLR, OneCycle, LRRangeTest; 763 LoC).

Schedules are host-side Python; the engine reads the LR each step. API mirrors torch schedulers:
``step()``, ``get_lr()``, ``get_last_lr()``, ``state_dict()``/``load_state_dict()``.
"""

from __future__ import annotations

import math
from typing import List, Optional

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


class _LRSchedule:
    def __init__(self, optimizer, last_batch_iteration: int = -1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration
        self._last_lr: List[float] = [0.0]

    def get_lr(self) -> List[float]:
        raise NotImplementedError

    def get_last_lr(self) -> List[float]:
        return self._last_lr

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = self.get_lr()
        if self.optimizer is not None and hasattr(self.optimizer, "lr"):
            self.optimizer.lr = self._last_lr[0]
        return self._last_lr[0]

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
        self._last_lr = self.get_lr()


class WarmupLR(_LRSchedule):
    """Linear/log warmup from warmup_min_lr to warmup_max_lr, then constant
    (reference lr_schedules.py WarmupLR)."""

    def __init__(self, optimizer=None, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = WARMUP_LOG_RATE, last_batch_iteration: int = -1):
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        super().__init__(optimizer, last_batch_iteration)

    def _get_gamma(self) -> float:
        if self.last_batch_iteration < self.warmup_num_steps:
            if self.warmup_type == WARMUP_LOG_RATE:
                return self.inverse_log_warm_up * math.log(self.last_batch_iteration + 1)
            return self.last_batch_iteration / self.warmup_num_steps
        return 1.0

    def get_lr(self) -> List[float]:
        if self.last_batch_iteration < 0:
            return [0.0]
        gamma = self._get_gamma()
        return [self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) * gamma]


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to zero at total_num_steps."""

    def __init__(self, optimizer=None, total_num_steps: int = 10000, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = WARMUP_LOG_RATE, last_batch_iteration: int = -1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)

    def _get_gamma(self) -> float:
        if self.last_batch_iteration < self.warmup_num_steps:
            return super()._get_gamma()
        return max(
            0.0,
            float(self.total_num_steps - self.last_batch_iteration) /
            float(max(1.0, self.total_num_steps - self.warmup_num_steps)))


class WarmupCosineLR(WarmupLR):
    """Warmup then cosine decay to cos_min_ratio * warmup_max_lr."""

    def __init__(self, optimizer=None, total_num_steps: int = 10000, warmup_min_ratio: float = 0.0,
                 warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                 warmup_type: str = WARMUP_LINEAR_RATE, warmup_max_lr: float = 0.001,
                 last_batch_iteration: int = -1):
        self.total_num_steps = total_num_steps
        self.cos_min_ratio = cos_min_ratio
        super().__init__(optimizer, warmup_min_ratio * warmup_max_lr, warmup_max_lr,
                         warmup_num_steps, warmup_type, last_batch_iteration)

    def _get_gamma(self) -> float:
        if self.last_batch_iteration < self.warmup_num_steps:
            return super()._get_gamma()
        progress = (self.last_batch_iteration - self.warmup_num_steps) / max(
            1, self.total_num_steps - self.warmup_num_steps)
        progress = min(1.0, progress)
        cosine = 0.5 * (1.0 + math.cos(math.pi * progress))
        return self.cos_min_ratio + (1 - self.cos_min_ratio) * cosine


class OneCycle(_LRSchedule):
    """1-cycle policy (reference lr_schedules.py OneCycle): lr ramps
    min→max→min over cycle then decays."""

    def __init__(self, optimizer=None, cycle_min_lr: float = 0.0001, cycle_max_lr: float = 0.001,
                 decay_lr_rate: float = 0.0, cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0, cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0, cycle_momentum: bool = False,
                 cycle_min_mom: float = 0.8, cycle_max_mom: float = 0.9,
                 decay_mom_rate: float = 0.0, last_batch_iteration: int = -1):
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = cycle_first_step_size
        self.second_size = cycle_second_step_size or cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.total_size = self.first_size + self.second_size
        super().__init__(optimizer, last_batch_iteration)

    def get_lr(self) -> List[float]:
        it = max(self.last_batch_iteration, 0)
        if it <= self.total_size:
            if it <= self.first_size:
                scale = it / self.first_size
            else:
                scale = 1.0 - (it - self.first_size) / self.second_size
            lr = self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * scale
        else:
            extra = it - self.total_size
            if self.decay_step_size > 0:
                decay = (extra // self.decay_step_size) * self.decay_lr_rate
            else:
                decay = extra * self.decay_lr_rate
            lr = max(self.cycle_min_lr / (1.0 + decay), 0.0) if self.decay_lr_rate else self.cycle_min_lr
        return [lr]


class LRRangeTest(_LRSchedule):
    """LR range test (reference lr_schedules.py LRRangeTest)."""

    def __init__(self, optimizer=None, lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000, lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False, last_batch_iteration: int = -1):
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        super().__init__(optimizer, last_batch_iteration)

    def get_lr(self) -> List[float]:
        it = max(self.last_batch_iteration, 0)
        if self.staircase:
            interval = float(it // self.step_size)
        else:
            interval = it / self.step_size
        return [self.min_lr * (1 + interval * self.step_rate)]


SCHEDULE_REGISTRY = {
    "WarmupLR": WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
    "WarmupCosineLR": WarmupCosineLR,
    "OneCycle": OneCycle,
    "LRRangeTest": LRRangeTest,
}

VALID_LR_SCHEDULES = list(SCHEDULE_REGISTRY)


def build_lr_scheduler(name: str, params: dict, optimizer=None) -> _LRSchedule:
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"unknown lr schedule '{name}'; valid: {VALID_LR_SCHEDULES}")
    return SCHEDULE_REGISTRY[name](optimizer=optimizer, **params)
