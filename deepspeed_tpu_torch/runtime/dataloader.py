"""Data loading (port of deepspeed_tpu/runtime/dataloader.py) — analog of
reference ``runtime/dataloader.py`` (DeepSpeedDataLoader + DistributedSampler
wiring, RepeatingLoader).

Batches are numpy; the engine moves them to its device. The port runs one
process, so ``num_replicas`` defaults to 1 and ``rank`` to 0 (the JAX
package reads them from its process count and index).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np


class RepeatingLoader:
    """Wraps an iterator to restart on StopIteration (reference RepeatingLoader)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    """Batches an indexable dataset into per-step numpy batches.

    - ``batch_size`` is the *micro* batch per data-parallel replica times the
      local replica count — i.e. the per-process slice of the global batch.
    - multi-host: each process reads its own shard (rank-strided, like the
      reference's DistributedSampler).

    Deterministic resume: the batch stream is a pure function of
    ``(seed, epoch, in-epoch offset)``. ``state_dict()/load_state_dict()``
    capture/restore that triple (the JAX package's engine persists it in
    every checkpoint; the port's checkpointing is not ported yet), so a
    restart replays *exactly* the batch stream an uninterrupted run would
    have seen. Each epoch reshuffles with ``seed + epoch`` and the
    loader auto-advances ``epoch`` on exhaustion, so wrap-around (via
    :class:`RepeatingLoader`) stays deterministic too.

    NOTE the contract change this implies: the loader is a
    position-tracking STREAM, not a restartable sequence. Every batch
    pulled — including via an abandoned partial iteration — advances the
    position that ``state_dict()`` reports and the next ``__iter__``
    resumes from; don't iterate the same instance from two places. To
    re-read from a known point, call ``set_epoch(e)`` (top of epoch
    ``e``) or ``load_state_dict``.
    """

    def __init__(self, dataset, batch_size: int, *, collate_fn: Optional[Callable] = None,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 num_replicas: Optional[int] = None, rank: Optional[int] = None,
                 data_sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_replicas = num_replicas if num_replicas is not None else 1
        self.rank = rank if rank is not None else 0
        self.epoch = 0
        self.data_sampler = data_sampler
        self._offset = 0  # batches already yielded in the current epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self._offset = 0

    def supports_deterministic_resume(self) -> bool:
        """The (seed, epoch, offset) triple pins the stream only when this
        loader generates its own index order; an external ``data_sampler``
        is re-pulled every epoch and may not replay (stateful/stochastic
        samplers), so its position cannot be promised across a restart."""
        return self.data_sampler is None

    def state_dict(self) -> dict:
        """Resume state: JSON-serializable, a few ints. The identity fields
        (batch_size/num_samples/replica/shuffle) are not restored;
        :meth:`resume_state_matches` compares them against the live loader
        so a warm-start onto a DIFFERENT dataset never inherits a stale
        mid-stream position."""
        return {"seed": int(self.seed), "epoch": int(self.epoch),
                "offset": int(self._offset),
                "batch_size": int(self.batch_size),
                "num_samples": int(len(self.dataset)),
                "num_replicas": int(self.num_replicas),
                "rank": int(self.rank),
                "shuffle": bool(self.shuffle)}

    def load_state_dict(self, state: dict):
        """Pin the stream position; takes effect at the next ``__iter__``
        (generators are lazy, so a ``RepeatingLoader`` built before this
        call still honors it as long as nothing was pulled yet)."""
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self._offset = int(state["offset"])

    def resume_state_matches(self, state: dict) -> bool:
        """Does ``state`` describe THIS data pipeline? Identity fields
        saved alongside the position must agree (fields absent from older
        checkpoints are not compared)."""
        current = self.state_dict()
        return all(state[k] == current[k]
                   for k in ("batch_size", "num_samples", "num_replicas",
                             "rank", "shuffle") if k in state)

    def __len__(self):
        n = len(self.dataset) // self.num_replicas
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        if self.data_sampler is not None:
            indices = list(self.data_sampler)
        else:
            indices = np.arange(n)
            if self.shuffle:
                rng = np.random.RandomState(self.seed + self.epoch)
                rng.shuffle(indices)
        indices = indices[self.rank::self.num_replicas]
        batch = []
        for idx in indices[self._offset * self.batch_size:]:
            batch.append(self.dataset[int(idx)])
            if len(batch) == self.batch_size:
                self._offset += 1
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            self._offset += 1
            yield self.collate_fn(batch)
        # epoch exhausted: advance so the next pass (RepeatingLoader
        # restart) reshuffles deterministically with seed + epoch
        self.epoch += 1
        self._offset = 0


def default_collate(samples):
    """Stack a list of samples (dicts / tuples / arrays) into numpy batches."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    arr = np.stack([np.asarray(s) for s in samples])
    return arr


def build_dataloader(dataset, batch_size: int, config=None, **kw) -> DeepSpeedDataLoader:
    drop_last = kw.pop("drop_last", None)
    if drop_last is None and config is not None:
        drop_last = config.dataloader_drop_last
    return DeepSpeedDataLoader(dataset, batch_size, drop_last=bool(drop_last), **kw)
