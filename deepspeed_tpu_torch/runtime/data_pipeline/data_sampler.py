"""Curriculum data sampler (copy of deepspeed_tpu/runtime/data_pipeline/
data_sampler.py for the PyTorch port) — analog of reference
``runtime/data_pipeline/data_sampling/data_sampler.py`` (DeepSpeedDataSampler
:36): difficulty-indexed sampling for data-efficiency curriculum learning.

Given per-sample difficulty scores (e.g. sequence length, loss from a pilot
run), each epoch samples only from the pool whose difficulty <= the current
curriculum difficulty, growing the pool as training progresses. Deterministic
across processes given the same seed (every host computes identical index
streams — the multi-host analog of the reference's broadcast at
data_sampler.py:224).
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler


class DeepSpeedDataSampler:
    def __init__(self, difficulties: Sequence[float], batch_size: int,
                 curriculum: CurriculumScheduler, *, seed: int = 1234,
                 drop_last: bool = True, global_rank: int = 0,
                 data_parallel_size: int = 1):
        self.difficulties = np.asarray(difficulties)
        self.batch_size = batch_size
        self.curriculum = curriculum
        self.seed = seed
        self.drop_last = drop_last
        self.global_rank = global_rank
        self.data_parallel_size = data_parallel_size
        assert batch_size % data_parallel_size == 0, (
            f"batch {batch_size} must divide over dp {data_parallel_size}")
        self.global_step = 0
        # sort once: pool for difficulty d = prefix of this ordering
        self._order = np.argsort(self.difficulties, kind="stable")
        self._sorted_diff = self.difficulties[self._order]

    def _pool(self) -> np.ndarray:
        d = self.curriculum.get_current_difficulty()
        n = int(np.searchsorted(self._sorted_diff, d, side="right"))
        n = max(n, self.batch_size)  # never starve the batch
        return self._order[:min(n, len(self._order))]

    def next_batch_indices(self) -> np.ndarray:
        """Global batch of sample indices for the current step (rank-sliced
        by ``local_slice``)."""
        self.curriculum.update_difficulty(self.global_step)
        pool = self._pool()
        rng = np.random.RandomState(self.seed + self.global_step)
        idx = rng.choice(pool, size=self.batch_size,
                         replace=len(pool) < self.batch_size)
        self.global_step += 1
        return idx

    def local_slice(self, batch_indices: np.ndarray) -> np.ndarray:
        per = self.batch_size // self.data_parallel_size
        r = self.global_rank % self.data_parallel_size
        return batch_indices[r * per:(r + 1) * per]

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.local_slice(self.next_batch_indices())

    def state_dict(self) -> Dict:
        return {"global_step": self.global_step,
                "curriculum": self.curriculum.state_dict()}

    def load_state_dict(self, sd: Dict):
        self.global_step = sd["global_step"]
        self.curriculum.load_state_dict(sd["curriculum"])
