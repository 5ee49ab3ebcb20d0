"""Curriculum scheduler (copy of deepspeed_tpu/runtime/data_pipeline/
curriculum_scheduler.py for the PyTorch port) — analog of reference
``deepspeed/runtime/data_pipeline/curriculum_scheduler.py`` (legacy
curriculum, engine.py:1653 injects ``curriculum_seqlen``).

Difficulty schedules: fixed_linear, fixed_root, fixed_discrete, custom —
same config schema as the reference (schedule_type + schedule_config with
min/max difficulty, total_curriculum_step, difficulty_step, root_degree or
discrete difficulty/max_step lists).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"
CUSTOM = "custom"


class CurriculumScheduler:
    def __init__(self, config: Dict):
        self.state: Dict = {}
        assert "curriculum_type" in config or "schedule_type" in config, (
            "curriculum config needs schedule_type/curriculum_type")
        self.curriculum_type = config.get("schedule_type",
                                          config.get("curriculum_type"))
        cfg = config.get("schedule_config", config)
        self.min_difficulty = cfg.get("min_difficulty", 1)
        self.max_difficulty = cfg.get("max_difficulty", 1)
        self.current_difficulty = self.min_difficulty
        self._custom_fn: Optional[Callable[[int], int]] = None

        if self.curriculum_type == FIXED_LINEAR:
            self.total_step = cfg["total_curriculum_step"]
            self.difficulty_step = cfg.get("difficulty_step", 1)
        elif self.curriculum_type == FIXED_ROOT:
            self.total_step = cfg["total_curriculum_step"]
            self.difficulty_step = cfg.get("difficulty_step", 1)
            self.root_degree = cfg.get("root_degree", 2)
        elif self.curriculum_type == FIXED_DISCRETE:
            self.difficulties = cfg["difficulty"]
            self.max_steps = cfg["max_step"]
            assert len(self.difficulties) == len(self.max_steps) + 1, (
                "fixed_discrete needs len(difficulty) == len(max_step)+1")
        elif self.curriculum_type == CUSTOM:
            pass
        else:
            raise ValueError(f"unknown curriculum schedule {self.curriculum_type!r}")

    def set_custom_get_difficulty(self, fn: Callable[[int], int]):
        assert self.curriculum_type == CUSTOM
        self._custom_fn = fn

    def get_current_difficulty(self) -> int:
        return self.current_difficulty

    def set_current_difficulty(self, difficulty: int):
        self.current_difficulty = difficulty

    def update_difficulty(self, global_steps: int) -> int:
        ct = self.curriculum_type
        if ct == FIXED_LINEAR:
            d = self.min_difficulty + (
                (self.max_difficulty - self.min_difficulty) *
                min(global_steps / self.total_step, 1.0))
            d = int(d // self.difficulty_step) * self.difficulty_step
        elif ct == FIXED_ROOT:
            frac = min(global_steps / self.total_step, 1.0) ** (1.0 / self.root_degree)
            d = self.min_difficulty + (self.max_difficulty - self.min_difficulty) * frac
            d = int(d // self.difficulty_step) * self.difficulty_step
        elif ct == FIXED_DISCRETE:
            d = self.difficulties[-1]
            for diff, step in zip(self.difficulties, self.max_steps):
                if global_steps < step:
                    d = diff
                    break
        else:  # custom
            assert self._custom_fn is not None, "custom curriculum needs a fn"
            d = self._custom_fn(global_steps)
        self.current_difficulty = max(self.min_difficulty,
                                      min(int(d), self.max_difficulty))
        return self.current_difficulty

    def get_difficulty(self, global_steps: int) -> int:
        return self.update_difficulty(global_steps)

    def state_dict(self) -> Dict:
        return {"current_difficulty": self.current_difficulty}

    def load_state_dict(self, sd: Dict):
        self.current_difficulty = sd["current_difficulty"]
