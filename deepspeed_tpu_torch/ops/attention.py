"""Attention ops of the PyTorch port (the non-block half of
deepspeed_tpu/ops/attention.py).

The port always keeps the logical unpacked stacked cache layout
``[L, B, Hkv, S, Dh]``. Single-token decode on a CUDA tensor routes to the
fused decode-step kernel (ops/decode_step.py); prefill blocks and CPU
tensors take the plain path: an in-place cache write plus
:func:`decode_attention`, as the JAX package leaves them to XLA. Caches are
updated in place and returned for the reference's call shape.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from deepspeed_tpu_torch.ops.decode_step import fused_decode_step, supports

_F32_MIN = torch.finfo(torch.float32).min


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q [B, T, H, Dh], k/v [B, S, H, Dh]; logits in the input dtype, then
    softmax in f32, probabilities cast back before P.V (the JAX rounding)."""
    t, dh = q.shape[1], q.shape[3]
    s = k.shape[1]
    scale = scale if scale is not None else dh ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if causal:
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril(s - t)
        logits = logits.masked_fill(~mask, _F32_MIN)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def alloc_kv_cache(num_layers: int, batch: int, num_kv_heads: int,
                   max_len: int, head_dim: int, dtype, device=None):
    """Zeros for one stacked cache tensor ``[L, B, Hkv, S, Dh]`` (call twice
    for K and V)."""
    return torch.zeros((num_layers, batch, num_kv_heads, max_len, head_dim),
                       dtype=dtype, device=device)


def cache_seq_len(k_full: torch.Tensor) -> int:
    return k_full.shape[3]


def cached_attention(q, k_full, v_full, k_new, v_new, layer: int,
                     idx: Union[int, torch.Tensor], *,
                     scale: Optional[float] = None):
    """One cached-attention layer step: write the new block's K/V at
    ``idx`` (a python int for a uniform batch, or a per-slot ``[B]`` int32
    tensor for continuous batching), attend, return
    ``(attn, k_full, v_full)``. Single-token steps on CUDA go to the fused
    kernel; everything else takes the write + einsum path."""
    t = q.shape[1]
    if (t == 1 and q.device.type == "cuda"
            and supports(q.shape[2], k_full.shape[2], k_full.shape[3],
                         q.shape[3], q.element_size())):
        return fused_decode_step(q, k_full, v_full, k_new, v_new, layer, idx,
                                 scale=scale)
    k_full, v_full, kl, vl = write_kv_cache(k_full, v_full, k_new, v_new,
                                            layer, idx)
    return decode_attention(q, kl, vl, idx, scale=scale), k_full, v_full


def write_kv_cache(k_full, v_full, k_new, v_new, layer: int, idx):
    """Write one block's new K/V ``[B, T, Hkv, Dh]`` into the stacked caches
    at ``(layer, idx)`` in place. A per-slot ``[B]`` idx scatters row b's
    token j to position ``idx[b] + j`` and drops positions past the
    allocation (``mode="drop"``: an inactive slot's stale length may equal
    max_len). A scalar idx is one slice write whose start is clamped so the
    block fits (``dynamic_update_slice`` semantics). Returns
    ``(k_full, v_full, k_layer, v_layer)`` with ``[B, Hkv, S, Dh]`` views."""
    kl, vl = k_full[layer], v_full[layer]
    b, t = k_new.shape[0], k_new.shape[1]
    s_max = k_full.shape[3]
    if isinstance(idx, torch.Tensor) and idx.ndim == 1:
        pos = idx.to(torch.long)[:, None] + torch.arange(t, device=idx.device)
        rows = torch.arange(b, device=idx.device)[:, None].expand(b, t)
        keep = (pos >= 0) & (pos < s_max)
        r, p = rows[keep], pos[keep]
        kl[r, :, p] = k_new[keep].to(k_full.dtype)
        vl[r, :, p] = v_new[keep].to(v_full.dtype)
    else:
        start = min(max(int(idx), 0), s_max - t)
        kl[:, :, start:start + t] = k_new.transpose(1, 2).to(k_full.dtype)
        vl[:, :, start:start + t] = v_new.transpose(1, 2).to(v_full.dtype)
    return k_full, v_full, kl, vl


def write_slot_prefix(k_full, v_full, k_pref, v_pref, slot: int):
    """Copy a prefilled single-sequence prefix cache ``[L, 1, Hkv, T, Dh]``
    into rows ``0..T-1`` of slot ``slot`` of the persistent slot caches, in
    place. Rows past the request's true length hold pad-token garbage that
    the per-slot length masks until decode overwrites them."""
    t_b = k_pref.shape[3]
    k_full[:, slot:slot + 1, :, :t_b] = k_pref.to(k_full.dtype)
    v_full[:, slot:slot + 1, :, :t_b] = v_pref.to(v_full.dtype)
    return k_full, v_full


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_index, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q ``[B, T, Hq, Dh]`` against a cache ``[B, Hkv, S, Dh]``
    that already holds its keys/values; query j of row b sits at position
    ``cache_index (+ [b]) + j`` and sees positions ``<=`` its own. GQA
    groups ``rep = Hq / Hkv`` query heads per kv head. Logits come out of
    the matmul in the input dtype, softmax runs in f32, probabilities are
    cast back before P.V (the JAX package's rounding points)."""
    b, t, hq, dh = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    rep = hq // hkv
    qg = q.reshape(b, t, hkv, rep, dh)
    logits = torch.einsum("btkrd,bksd->bkrts", qg, k_cache).float() * scale
    pos = torch.arange(s_max, device=q.device)
    tt = torch.arange(t, device=q.device)
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        q_pos = cache_index.to(torch.long)[:, None, None] + tt[None, :, None]
        valid = pos[None, None, :] <= q_pos                   # [B, T, S]
        valid = valid[:, None, None]
    else:
        valid = pos[None, :] <= (int(cache_index) + tt)[:, None]  # [T, S]
    logits = logits.masked_fill(~valid, _F32_MIN)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkrts,bksd->btkrd", probs, v_cache)
    return out.reshape(b, t, hq, dh)
