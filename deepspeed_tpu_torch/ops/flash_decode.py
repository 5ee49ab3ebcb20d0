"""Flash-decode: one new token's attention over a head-major KV cache (port
of deepspeed_tpu/ops/flash_decode.py ``flash_decode``).

``q [B, 1, Hq, Dh]`` against ``[B, Hkv, S, Dh]`` caches whose position
``cache_index`` already holds the new token's K/V, over positions
``<= cache_index``. Two computations, kept apart as in the reference
because their rounding differs:

* rep = Hq / Hkv >= 2 (the TPU ``_kernel``): scores from the stored values
  summed in f32, probabilities rounded to the V dtype before P.V;
* rep == 1 (the TPU ``_mha_kernel``, :func:`flash_decode_mha`): all in
  f32, probabilities not rounded. Unrouted, as in the reference.

On a CUDA tensor each launches ``csrc/flash_decode.cu``, split along the
valid prefix and then merged (the source note says what bounds it): rep >= 2
runs kernel B's attention body (``csrc/decode_split.cuh``) under kernel B's
plan (``decode_step.split_plan``) with its merge as a programmatic
dependent launch, rep == 1 its own streaming kernel (TMA ring, a lane per
position, f32 on the CUDA cores) under :func:`plan`, with the same merge
where the plan splits. On a CPU tensor each runs
:func:`flash_decode_plain`. A CUDA call the kernel cannot take raises
``ValueError``; nothing falls back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from deepspeed_tpu_torch.ops import cuda_build, decode_step, kernel_flops

HEAD_DIMS = (64, 128, 256)          # csrc/flash_decode.cu instantiations
STAGE_POSITIONS = 32                # csrc/flash_decode.cu mha::kPos


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, cache_index, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of both kernels: masked softmax attention of the one
    query position over positions ``<= cache_index``, scores in f32 from the
    stored values times ``scale``; for rep >= 2 the probabilities are
    rounded to the V dtype before P.V, for rep == 1 they stay f32; the
    output is ``acc / max(l, 1e-20)``, cast once (0 where no position is
    valid, as the reference)."""
    b, t, hq, dh = q.shape
    if t != 1:
        raise ValueError("flash_decode is the single-token path")
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    sc = float(scale) if scale is not None else dh ** -0.5
    qg = q.reshape(b, hkv, rep, dh).float()
    s = torch.einsum("bkrd,bksd->bkrs", qg, k_cache.float()) * sc
    idx = (cache_index.reshape(()) if isinstance(cache_index, torch.Tensor)
           else int(cache_index))       # no host-to-device copy: capturable
    valid = torch.arange(s_max, device=q.device) <= idx
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(-1, keepdim=True).clamp_min(torch.finfo(torch.float32).min)
    p = torch.exp(s - m)
    l = p.sum(-1)
    if rep > 1:
        p = p.to(v_cache.dtype)
    acc = torch.einsum("bkrs,bksd->bkrd", p.float(), v_cache.float())
    out = (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)
    return out.reshape(b, 1, hq, dh)


def plan(b: int, heads: int, s_max: int, sms: int):
    """``(chunk, n_splits)`` of the rep-1 kernel: positions per block and
    blocks along S. The whole prefix in one block per head (no merge) while
    the heads alone give every SM a block; otherwise the chunk halves, in
    whole 32-position stages and no shorter than 64, until they do.
    ``heads`` is the grid's middle dimension; the head width does not
    enter (every width streams the same way). A function of the shapes and
    the SM count only, so a row's result does not depend on idx."""
    chunk = -(-s_max // STAGE_POSITIONS) * STAGE_POSITIONS
    while chunk > 64 and b * heads * -(-s_max // chunk) < sms:
        chunk = max(64, -(-chunk // (2 * STAGE_POSITIONS)) * STAGE_POSITIONS)
    return chunk, -(-s_max // chunk)


def _launch(q, k_cache, v_cache, cache_index, scale, mha: bool, what: str):
    b, t, hq, dh = q.shape
    if t != 1:
        raise ValueError(f"{what} is the single-token path")
    if k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{what}: caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} are not [B, Hkv, S, Dh]")
    b2, hkv, s_max, dh2 = k_cache.shape
    if (b2, dh2) != (b, dh):
        raise ValueError(f"{what}: cache {tuple(k_cache.shape)} vs q "
                         f"{tuple(q.shape)}")
    dtype = q.dtype
    rep = hq // hkv if hkv else 0
    if (dh not in HEAD_DIMS or hkv <= 0 or hq % hkv or s_max <= 0
            or (rep == 1) != mha):
        raise ValueError(f"{what}: unsupported geometry hq={hq} hkv={hkv} "
                         f"S={s_max} dh={dh} (Dh in {HEAD_DIMS}; rep "
                         f"{'== 1' if mha else '>= 2'})")
    for name, tns in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if tns.device != q.device or tns.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} on {q.device}, "
                             f"got {tns.dtype} on {tns.device}")
        if not tns.is_contiguous() or tns.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             "aligned")
    if isinstance(cache_index, torch.Tensor):
        if (cache_index.device != q.device or cache_index.dtype != torch.int32
                or cache_index.numel() != 1):
            raise ValueError(f"{what}: cache_index must be a python int or "
                             f"a one-element int32 tensor on {q.device}, got "
                             f"{cache_index.dtype} {tuple(cache_index.shape)} "
                             f"on {cache_index.device}")
        idx_ptr, idx_scalar = cache_index.data_ptr(), 0
    else:
        idx_ptr, idx_scalar = None, int(cache_index)
    sms = cuda_build.sm_count(q.device.index or 0)
    chunk, n_splits = (plan(b, hkv, s_max, sms) if mha
                       else decode_step.split_plan(b, hkv, s_max, sms, dh,
                                                   q.element_size()))
    sc = float(scale) if scale is not None else dh ** -0.5
    lib = cuda_build.kernels()
    out = torch.empty((b, 1, hq, dh), dtype=dtype, device=q.device)
    ml = acc = None
    if n_splits > 1:
        ml = torch.empty((b, hq, n_splits, 2), dtype=torch.float32,
                         device=q.device)
        acc = torch.empty((b, hq, n_splits, dh), dtype=torch.float32,
                          device=q.device)
    err = lib.dst_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        None if ml is None else ml.data_ptr(),
        None if acc is None else acc.data_ptr(), idx_ptr, idx_scalar, b, hq,
        hkv, s_max, dh, chunk, n_splits, sc, cuda_build.dtype_code(dtype),
        int(mha), torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, err, what)
    return out


def _report(name: str, q, k_cache, cache_index) -> None:
    """The kernel's products to the FLOPs profiler (ops/kernel_flops.py); a
    tensor index is read only while it counts."""
    if kernel_flops.counting():
        b, _, hq, dh = q.shape
        kernel_flops.report(name, kernel_flops.decode_flops(
            hq, dh, cache_index, b, k_cache.shape[2]))


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor,
                 cache_index: Union[int, torch.Tensor], *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """``q [B, 1, Hq, Dh]`` against head-major ``[B, Hkv, S, Dh]`` caches
    whose position ``cache_index`` holds q's own K/V (already written).
    ``cache_index`` is a python int or a one-element int32 tensor on q's
    device (read by the kernel, never by the host). Returns ``[B, 1, Hq,
    Dh]``. rep == 1 goes to :func:`flash_decode_mha`, as the reference
    dispatches to its ``_mha_kernel``."""
    if q.shape[2] == k_cache.shape[1]:
        return flash_decode_mha(q, k_cache, v_cache, cache_index, scale=scale)
    if q.device.type == "cpu":
        _report("flash_decode", q, k_cache, cache_index)
        return kernel_flops.plain(flash_decode_plain, q, k_cache, v_cache,
                                  cache_index, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    out = _launch(q, k_cache, v_cache, cache_index, scale, False,
                  "flash_decode")
    flash_decode.launches += 1
    _report("flash_decode", q, k_cache, cache_index)
    return out


flash_decode.launches = 0


def flash_decode_mha(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_index: Union[int, torch.Tensor], *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """The rep == 1 computation of :func:`flash_decode` (the reference's
    ``_mha_kernel``: q, K and V upcast to f32, probabilities not rounded)."""
    if q.device.type == "cpu":
        _report("flash_decode_mha", q, k_cache, cache_index)
        return kernel_flops.plain(flash_decode_plain, q, k_cache, v_cache,
                                  cache_index, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_mha: unsupported device {q.device}")
    out = _launch(q, k_cache, v_cache, cache_index, scale, True,
                  "flash_decode_mha")
    flash_decode_mha.launches += 1
    _report("flash_decode_mha", q, k_cache, cache_index)
    return out


flash_decode_mha.launches = 0
