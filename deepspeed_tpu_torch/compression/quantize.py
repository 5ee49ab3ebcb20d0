"""Int8 weight quantization (port of deepspeed_tpu/compression/quantize.py
``quantize_int8`` / ``dequantize_int8``).

Bit-identical to the JAX rounding: the scale is ``max|x| / 127`` in f32
with a ``1e-10`` floor, the division runs in f32, ``torch.round`` rounds
half to even exactly like ``jnp.round``, and the result is clipped to
``[-128, 127]``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def quantize_int8(x: torch.Tensor, *, per_channel_axis: Optional[int] = None,
                  reduce_dims: Optional[Tuple[int, ...]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real int8 quantization -> (int8 values, f32 scales with the reduced
    dims kept). ``per_channel_axis`` keeps one scale per index of that axis
    (the JAX signature); ``reduce_dims`` names the reduced dims directly,
    which lets the engine quantize a layer-stacked ``[L, D, E]`` weight
    per layer and per output column in one call (``reduce_dims=(1,)``,
    the JAX engine's ``vmap`` over L)."""
    if reduce_dims is None:
        if per_channel_axis is not None:
            axis = per_channel_axis % x.ndim
            reduce_dims = tuple(i for i in range(x.ndim) if i != axis)
        else:
            reduce_dims = tuple(range(x.ndim))
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=reduce_dims, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-10)
    q = torch.clamp(torch.round(x32 / scale), -128, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)
