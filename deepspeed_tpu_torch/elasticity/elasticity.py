"""Elastic batch-ladder computation (port of
deepspeed_tpu/elasticity/elasticity.py) — analog of reference
``deepspeed/elasticity/elasticity.py`` (compute_elastic_config:233,
get_valid_gpus, get_candidate_batch_sizes).

Purpose (reference §5.3): pre-compute ONE train batch size compatible with
*every* admissible world size, so a job can resize (chips added/removed, a
a node preempted) without hyperparameter drift. It pairs with the
checkpoints (runtime/checkpoint_engine/), whose arrays are stored whole:
resize = restart on the new world size + load; the batch ladder
guarantees train_batch = micro * gas * dp still solves exactly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.elasticity.config import (
    ElasticityConfig,
    ElasticityConfigError,
    ElasticityIncompatibleWorldSize,
)


def get_candidate_batch_sizes(micro_batches: List[int],
                              max_acceptable_batch_size: int) -> List[int]:
    """Power-of-two multiples of each micro-batch up to the cap (reference
    get_candidate_batch_sizes)."""
    candidates = set()
    for micro in micro_batches:
        b = micro
        while b <= max_acceptable_batch_size:
            candidates.add(b)
            b *= 2
    return sorted(candidates)


def get_valid_gpus(batch_size: int, micro_batches: List[int],
                   min_valid_gpus: int, max_valid_gpus: int) -> List[int]:
    """GPU/chip counts that divide ``batch_size`` cleanly through some
    micro-batch (reference get_valid_gpus)."""
    valid = []
    for g in range(min_valid_gpus, max_valid_gpus + 1):
        if any(batch_size % (micro * g) == 0 for micro in micro_batches):
            valid.append(g)
    return valid


def _best_candidate(candidates: List[int], micro_batches: List[int],
                    min_gpus: int, max_gpus: int,
                    prefer_larger: bool) -> Tuple[Optional[int], List[int]]:
    best_batch, best_gpus = None, []
    for batch in (sorted(candidates, reverse=prefer_larger)):
        gpus = get_valid_gpus(batch, micro_batches, min_gpus, max_gpus)
        if len(gpus) > len(best_gpus):
            best_batch, best_gpus = batch, gpus
    return best_batch, best_gpus


def elasticity_enabled(ds_config: Dict) -> bool:
    return bool(ds_config.get("elasticity", {}).get("enabled", False))


def compute_elastic_config(ds_config: Dict, target_deepspeed_version: str = "",
                           world_size: int = 0, return_microbatch: bool = False):
    """reference compute_elastic_config:233.

    Returns ``(final_batch_size, valid_gpus)``; with ``world_size`` > 0 also
    validates compatibility and returns the largest micro-batch that solves
    batch = micro * gas * world as a third element.
    """
    cfg = ElasticityConfig(**ds_config.get("elasticity", {})).validate()
    if not cfg.enabled:
        raise ElasticityConfigError("elasticity is not enabled in this config")

    candidates = get_candidate_batch_sizes(cfg.micro_batch_sizes,
                                           cfg.max_train_batch_size)
    final_batch, valid_gpus = _best_candidate(
        candidates, cfg.micro_batch_sizes, cfg.min_gpus, cfg.max_gpus,
        cfg.prefer_larger_batch)
    if final_batch is None:
        raise ElasticityConfigError(
            f"no batch size <= {cfg.max_train_batch_size} works for micro "
            f"batches {cfg.micro_batch_sizes} and gpus "
            f"[{cfg.min_gpus}, {cfg.max_gpus}]")

    if world_size > 0:
        if world_size not in valid_gpus:
            raise ElasticityIncompatibleWorldSize(
                f"world size {world_size} is not in the valid set "
                f"{valid_gpus} for elastic batch {final_batch}")
        micro = max(m for m in cfg.micro_batch_sizes
                    if final_batch % (m * world_size) == 0)
        return final_batch, valid_gpus, micro
    if return_microbatch:
        micro = max(m for m in cfg.micro_batch_sizes if final_batch % m == 0)
        return final_batch, valid_gpus, micro
    return final_batch, valid_gpus
