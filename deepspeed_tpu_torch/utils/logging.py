"""Rank-filtered logging (copy of deepspeed_tpu/utils/logging.py for the
PyTorch port). The rank is ``torch.distributed``'s when a process group is
up, else ``DSTPU_PROCESS_INDEX`` (default 0)."""

from __future__ import annotations

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch",
                   level=logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    formatter = logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s")
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setLevel(level)
    handler.setFormatter(formatter)
    lg.addHandler(handler)
    return lg


logger = _create_logger(
    "deepspeed_tpu_torch",
    LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info"), logging.INFO))


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("DSTPU_PROCESS_INDEX", 0))


def log_dist(message: str, ranks=None, level=logging.INFO) -> None:
    """Log only on the given process ranks (None or [-1] => all ranks)."""
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
