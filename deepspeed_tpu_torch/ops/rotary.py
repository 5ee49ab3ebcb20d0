"""Rotary position embeddings (port of deepspeed_tpu/ops/rotary.py).
Elementwise work that PyTorch runs as a few fused-by-nothing ops; it is
not a kernel of the TPU package either."""

from __future__ import annotations

from typing import Union

import torch


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                     device=None):
    """cos/sin tables ``[T, Dh/2]`` in f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary_pos_emb(x: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor,
                         position_offset: Union[int, torch.Tensor] = 0
                         ) -> torch.Tensor:
    """x: [B, T, H, Dh]; cos/sin: [T_max, Dh/2]. Pairs (x[2i], x[2i+1])
    are rotated by the position angle (the interleaved convention the JAX
    package uses). ``position_offset`` may be a per-slot ``[B]`` tensor:
    each batch row is then rotated at its own position. Positions past
    the table are clamped to its last row, as JAX's gather clamps (an
    inactive serving slot's stale length may sit at the table's end)."""
    b, t, h, dh = x.shape
    t_max = cos.shape[0]
    ar = torch.arange(t, device=x.device)
    if isinstance(position_offset, torch.Tensor) and position_offset.ndim == 1:
        pos = position_offset.to(torch.long)[:, None] + ar[None, :]  # [B, T]
        pos = pos.clamp(0, t_max - 1)
        c = cos[pos][:, :, None, :]
        s = sin[pos][:, :, None, :]
    else:
        pos = (int(position_offset) + ar).clamp(0, t_max - 1)
        c = cos[pos][None, :, None, :]
        s = sin[pos][None, :, None, :]
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    return torch.stack([o1, o2], dim=-1).reshape(b, t, h, dh).to(x.dtype)
