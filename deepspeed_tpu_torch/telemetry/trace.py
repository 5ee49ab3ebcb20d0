"""Profiler trace capture of the port (port of
deepspeed_tpu/telemetry/trace.py): ``telemetry.trace(path)``.

A context manager over ``torch.profiler`` (host and, where there is a card,
CUDA activity) that writes a Chrome/Perfetto trace ``trace.json`` into the
directory ``path``. Kernels replayed from a CUDA graph appear as device
events inside it. :func:`annotate` names a range (``record_function``,
and an NVTX range on the card), which appears inside the trace.

A profiler that cannot start or export is reported once and the block
runs untraced: a trace is never worth crashing the run it observes.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

from deepspeed_tpu_torch.utils.logging import logger


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named profiler range (``with telemetry.annotate("decode"): ...``)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@contextlib.contextmanager
def trace(path: str) -> Iterator[str]:
    """Profile the enclosed block into ``path/trace.json`` (the directory
    is created). Yields ``path``::

        with telemetry.trace("serve_trace"):
            serving_engine.run(requests)
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(path, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as e:
        logger.warning(f"telemetry.trace: cannot start the profiler "
                       f"({type(e).__name__}: {e}); running untraced")
        prof = None
    try:
        yield str(path)
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(path, "trace.json"))
            except Exception as e:
                logger.warning(f"telemetry.trace: export failed "
                               f"({type(e).__name__}: {e})")
