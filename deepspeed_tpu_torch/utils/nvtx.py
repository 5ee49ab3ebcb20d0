"""Profiler ranges of the port (port of deepspeed_tpu/utils/nvtx.py, the
analog of the reference's ``deepspeed/utils/nvtx.py:instrument_w_nvtx``).

On the card a range is an NVTX range (``torch.cuda.nvtx``) and a
``torch.profiler.record_function`` range, so it appears both in Nsight and
in a ``telemetry.trace`` capture; without a card only the latter.
"""

from __future__ import annotations

import functools

import torch


def instrument_w_nvtx(func):
    """Wrap ``func`` in a range named after its qualified name."""
    name = getattr(func, "__qualname__", getattr(func, "__name__", "fn"))

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        from deepspeed_tpu_torch.telemetry.trace import annotate

        with annotate(name):
            return func(*args, **kwargs)

    return wrapped


def range_push(msg: str) -> None:
    """Open an NVTX range (no-op without a card)."""
    if torch.cuda.is_available():
        torch.cuda.nvtx.range_push(msg)


def range_pop() -> None:
    """Close the innermost NVTX range (no-op without a card)."""
    if torch.cuda.is_available():
        torch.cuda.nvtx.range_pop()
