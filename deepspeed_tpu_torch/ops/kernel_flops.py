"""FLOPs of the hand-written kernels, for the FLOPs profiler.

A kernel launched through ctypes is invisible to torch's dispatcher, so
``torch.utils.flop_counter.FlopCounterMode`` cannot count it. Each kernel
wrapper therefore reports its own work with :func:`report` (the products
the kernel computes, two operations per multiply-add), whichever route it
takes; on the CPU route its plain version runs through :func:`plain`,
which measures what the open counters' dispatch-level count grew by during
the call so that the profiler can take it back out. So one model and
batch give the same count on the CPU and on the card, and no product is
counted twice. With no counter open both cost nothing.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional


class KernelFlops:
    """One open count: ``kernels`` (name → FLOPs reported), and ``hidden``,
    the FLOPs that ``probe`` (the dispatch-level counter's running total)
    saw inside plain versions."""

    def __init__(self, probe: Optional[Callable[[], float]] = None):
        self.probe = probe
        self.kernels: Dict[str, float] = {}
        self.hidden = 0.0

    @property
    def total(self) -> float:
        return sum(self.kernels.values())


_OPEN: List[KernelFlops] = []


def counting() -> bool:
    """Whether a count is open (a wrapper whose work depends on device data
    reads it only then)."""
    return bool(_OPEN)


def report(name: str, flops: float) -> None:
    """Add ``flops`` under ``name`` to every open count."""
    for c in _OPEN:
        c.kernels[name] = c.kernels.get(name, 0.0) + float(flops)


def plain(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` (a kernel's plain version); while counts are
    open, what their probes saw during the call is added to ``hidden``."""
    if not _OPEN:
        return fn(*args, **kwargs)
    before = [c.probe() if c.probe else 0.0 for c in _OPEN]
    out = fn(*args, **kwargs)
    for c, b in zip(list(_OPEN), before):
        if c.probe:
            c.hidden += c.probe() - b
    return out


@contextlib.contextmanager
def kernel_flops_counter(probe: Optional[Callable[[], float]] = None):
    """Open a count (:class:`KernelFlops`) for the ``with`` block."""
    c = KernelFlops(probe)
    _OPEN.append(c)
    try:
        yield c
    finally:
        _OPEN.remove(c)


def decode_flops(hq: int, dh: int, idx, b: int, s_max: int) -> int:
    """A decode kernel's products: q.k^T and p.V for each of ``hq`` heads
    of each of ``b`` rows over positions ``<= idx`` (a python int, or a
    one-element or ``[b]`` tensor, read to the host), at most ``s_max``."""
    import torch

    if isinstance(idx, torch.Tensor):
        v = idx.detach().reshape(-1).long().cpu().expand(b)
    else:
        v = torch.full((b,), int(idx), dtype=torch.long)
    return 4 * hq * dh * int((v + 1).clamp(0, s_max).sum())


def attn_pairs(tq: int, tk: int, causal: bool) -> int:
    """(query, key) pairs a flash kernel visits: all, or under top-left
    causal masking ``min(i + 1, tk)`` for query row i."""
    if not causal:
        return tq * tk
    if tk >= tq:
        return tq * (tq + 1) // 2
    return tk * (tk + 1) // 2 + (tq - tk) * tk
