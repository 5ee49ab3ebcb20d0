"""Fused single-token decode step (port of deepspeed_tpu/ops/decode_step.py
``supports`` / ``fused_decode_step``).

One call per layer per decode step: write the new token's K/V into the
stacked ``[L, B, Hkv, S, Dh]`` cache in place (dropped for a slot whose
index is past the allocation), then attend each slot over its own valid
prefix. On CUDA tensors it launches the hand-written kernel in
``csrc/decode_step.cu`` (the replacement of the TPU kernel
``ops/decode_step.py:_kernel``; its source note says what bounds it and how
the design answers that). On CPU tensors it runs
:func:`fused_decode_step_plain`. The port keeps the logical unpacked cache
layout: the TPU's token-pair packing for Dh < 128 is an HBM-tiling device
with no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from deepspeed_tpu_torch.ops import cuda_build

_THREADS, _MAX_PER_THREAD = 128, 16   # csrc/decode_step.cu block shape


def supports(hq: int, hkv: int, s_max: int, dh: int, itemsize: int = 2) -> bool:
    """Shapes the CUDA kernel takes: whole GQA groups, 16-byte K/V rows,
    and a kv head's query group within one block's registers."""
    return (hkv > 0 and hq % hkv == 0 and s_max > 0
            and (dh * itemsize) % 16 == 0
            and (hq // hkv) * dh <= _THREADS * _MAX_PER_THREAD)


def _idx_vector(idx, b: int, device) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.long).reshape(-1).expand(b)
    return torch.full((b,), int(idx), dtype=torch.long, device=device)


def fused_decode_step_plain(q, k_full, v_full, k_new, v_new, layer: int, idx,
                            *, scale: Optional[float] = None):
    """Plain version: the write with drop, then masked softmax attention
    with the kernel's rounding points (scores in f32 from the stored
    values, probabilities rounded to the cache dtype before P.V, output
    divided by max(l, 1e-20) and cast once)."""
    b, t, hq, dh = q.shape
    _, _, hkv, s_max, _ = k_full.shape
    rep = hq // hkv
    sc = float(scale) if scale is not None else dh ** -0.5
    iv = _idx_vector(idx, b, q.device)
    kl, vl = k_full[layer], v_full[layer]              # views [B, Hkv, S, Dh]
    # the dropped rows rewrite what they hold, so the write needs no host
    # sync (the plain version stays usable inside a CUDA graph)
    keep = ((iv >= 0) & (iv < s_max))[:, None, None]
    rows, pos = torch.arange(b, device=q.device), iv.clamp(0, s_max - 1)
    kl[rows, :, pos] = torch.where(keep, k_new[:, 0].to(k_full.dtype),
                                   kl[rows, :, pos])
    vl[rows, :, pos] = torch.where(keep, v_new[:, 0].to(v_full.dtype),
                                   vl[rows, :, pos])
    qg = q.reshape(b, hkv, rep, dh).float()
    s = torch.einsum("bkrd,bksd->bkrs", qg, kl.float()) * sc
    valid = torch.arange(s_max, device=q.device)[None, :] <= iv[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)
    pv = torch.einsum("bkrs,bksd->bkrd", p.to(v_full.dtype).float(), vl.float())
    out = (pv / l.clamp_min(1e-20)[..., None]).to(q.dtype)
    return out.reshape(b, 1, hq, dh), k_full, v_full


def fused_decode_step(q: torch.Tensor, k_full: torch.Tensor,
                      v_full: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, layer: int,
                      idx: Union[int, torch.Tensor], *,
                      scale: Optional[float] = None):
    """One decode layer-step against the full stacked cache.

    q:             [B, 1, Hq, Dh]   the new token's queries
    k_full/v_full: [L, B, Hkv, S, Dh] stacked caches, updated in place
    k_new/v_new:   [B, 1, Hkv, Dh]  the new token's K/V (not yet written)
    layer:         python int
    idx:           python int (every slot) or an int32 ``[B]`` tensor on the
                   same device of per-slot write positions / valid lengths;
                   read by the kernel, never by the host.

    Returns ``(attn [B, 1, Hq, Dh], k_full, v_full)``; the returned caches
    are the inputs, written in place."""
    if q.device.type == "cpu":
        return fused_decode_step_plain(q, k_full, v_full, k_new, v_new,
                                       layer, idx, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_step: unsupported device {q.device}")
    b, t, hq, dh = q.shape
    if t != 1:
        raise ValueError("fused_decode_step is the single-token path")
    nl, b2, hkv, s_max, dh2 = k_full.shape
    if (b2, dh2) != (b, dh) or v_full.shape != k_full.shape:
        raise ValueError(f"cache {tuple(k_full.shape)} / {tuple(v_full.shape)} "
                         f"vs q {tuple(q.shape)}")
    if k_new.shape != (b, 1, hkv, dh) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new {tuple(k_new.shape)} != {(b, 1, hkv, dh)}")
    dtype = q.dtype
    if not supports(hq, hkv, s_max, dh, q.element_size()):
        raise ValueError(f"fused_decode_step: unsupported geometry "
                         f"hq={hq} hkv={hkv} S={s_max} dh={dh} {dtype}")
    if not 0 <= int(layer) < nl:
        raise ValueError(f"layer {layer} outside [0, {nl})")
    for name, tns in (("q", q), ("k_full", k_full), ("v_full", v_full),
                      ("k_new", k_new), ("v_new", v_new)):
        if tns.device != q.device or tns.dtype != dtype:
            raise ValueError(f"fused_decode_step: {name} must be {dtype} on {q.device}")
        if not tns.is_contiguous() or tns.data_ptr() % 16:
            raise ValueError(f"fused_decode_step: {name} must be contiguous "
                             "and 16-byte aligned")
    if isinstance(idx, torch.Tensor):
        if (idx.device != q.device or idx.dtype != torch.int32
                or idx.shape != (b,) or not idx.is_contiguous()):
            raise ValueError(f"fused_decode_step: idx must be an int32 [{b}] "
                             f"tensor on {q.device}, got {idx.dtype} "
                             f"{tuple(idx.shape)} on {idx.device}")
        idx_ptr, idx_scalar = idx.data_ptr(), 0
    else:
        idx_ptr, idx_scalar = None, int(idx)
    sc = float(scale) if scale is not None else dh ** -0.5
    lib = cuda_build.kernels()
    out = torch.empty((b, 1, hq, dh), dtype=dtype, device=q.device)
    err = lib.dst_fused_decode_step(
        q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), out.data_ptr(), idx_ptr, idx_scalar, int(layer),
        b, hq, hkv, s_max, dh, sc, cuda_build.dtype_code(dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, err, "fused_decode_step")
    fused_decode_step.launches += 1
    return out, k_full, v_full


fused_decode_step.launches = 0
