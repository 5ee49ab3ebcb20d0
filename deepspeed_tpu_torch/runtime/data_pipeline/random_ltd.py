"""Random layerwise token dropping, random-LTD (port of
deepspeed_tpu/runtime/data_pipeline/random_ltd.py; reference
``runtime/data_pipeline/data_routing/``: basic_layer.py
RandomLayerTokenDrop and scheduler.py RandomLTDScheduler).

The reference turned the upstream CUDA token gather/scatter kernels into
array takes; here they are ``torch.gather`` and an out-of-place
``torch.scatter`` (both differentiable), with the kept-token count a
python int per step. Each middle layer draws its own sorted subset of
token positions, so the reduced sequence stays causal with respect to the
original order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _expand(indices: torch.Tensor, d: int) -> torch.Tensor:
    return indices.unsqueeze(-1).expand(*indices.shape, d)


def gather_tokens(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """x ``[B, T, D]``, indices ``[B, T_keep]`` → ``[B, T_keep, D]``."""
    return torch.gather(x, 1, _expand(indices, x.shape[-1]))


def scatter_tokens(full: torch.Tensor, kept: torch.Tensor,
                   indices: torch.Tensor) -> torch.Tensor:
    """``full`` with rows ``indices`` of each batch row replaced by
    ``kept`` (out of place)."""
    return torch.scatter(full, 1, _expand(indices, full.shape[-1]),
                         kept.to(full.dtype))


def sample_token_indices(generator: Optional[torch.Generator], batch: int,
                         seq_len: int, keep: int, device=None) -> torch.Tensor:
    """Sorted random subset of ``keep`` token positions per batch row
    (int64 ``[B, keep]``): uniform noise, its argsort's first ``keep``
    positions, sorted."""
    if generator is not None and device is None:
        device = generator.device
    noise = torch.rand((batch, seq_len), generator=generator, device=device)
    idx = torch.argsort(noise, dim=-1)[:, :keep]
    return torch.sort(idx, dim=-1).values


def random_ltd_token_drop(x: torch.Tensor, generator, keep: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop tokens for one layer: returns ``(kept_tokens, indices)``."""
    b, t = x.shape[0], x.shape[1]
    idx = sample_token_indices(generator, b, t, keep, device=x.device)
    return gather_tokens(x, idx), idx


class RandomLTDScheduler:
    """Kept-token schedule (reference data_routing/scheduler.py): a linear
    ramp from ``start_seq`` to ``full_seq`` over ``total_steps``, in
    ``increment`` granules."""

    def __init__(self, config: Dict):
        cfg = config.get("random_ltd", config)
        self.start_seq = cfg.get("random_ltd_schedule", {}).get(
            "min_value", cfg.get("min_value", 128))
        self.full_seq = cfg.get("random_ltd_schedule", {}).get(
            "max_value", cfg.get("max_value", 512))
        sched = cfg.get("random_ltd_schedule", cfg)
        self.total_steps = sched.get("schedule_config", sched).get(
            "total_layer_tokens_steps", sched.get("total_steps", 1000))
        self.increment = sched.get("schedule_config", sched).get(
            "seq_per_step", sched.get("increment", 16))
        self.current_seq = self.start_seq

    def update_seq(self, global_step: int) -> int:
        frac = min(global_step / max(self.total_steps, 1), 1.0)
        seq = self.start_seq + (self.full_seq - self.start_seq) * frac
        seq = int(seq // self.increment) * self.increment
        self.current_seq = max(self.start_seq, min(seq, self.full_seq))
        return self.current_seq

    def get_current_seq(self) -> int:
        return self.current_seq

    def state_dict(self) -> Dict:
        return {"current_seq": self.current_seq}

    def load_state_dict(self, sd: Dict):
        self.current_seq = sd["current_seq"]
