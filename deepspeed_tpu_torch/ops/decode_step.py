"""Fused single-token decode steps (port of deepspeed_tpu/ops/decode_step.py
``supports`` / ``fused_decode_step`` and ``supports_block`` /
``fused_block_decode_step``).

One call per layer per decode step: write the new token's K/V in place,
then attend each slot over its own valid prefix.

* ``fused_decode_step``: the stacked slot cache ``[L, B, Hkv, S, Dh]``; the
  write is dropped for a slot whose index is past the allocation. CUDA
  tensors launch ``csrc/decode_step.cu`` (replaces the TPU kernel
  ``ops/decode_step.py:_kernel``): the valid prefix split across blocks
  (:func:`split_plan`, flash-decode's plan too), the splits merged by a
  second kernel.
* ``fused_block_decode_step``: the block pool ``[L, N+1, Hkv, bs, Dh]``
  addressed through a ``[B, MB]`` block table, in the compute dtype or
  quantized (``{"q", "s"}`` int8/fp8 payload + bf16 scales, quantized on
  store). A position past the table width is written to the garbage row
  ``N``. CUDA tensors launch ``csrc/block_decode_step.cu`` (replaces
  ``ops/decode_step.py:_block_kernel``): the same split and merge as the
  slot kernel, with table-addressed rows (an 8-bit pool staged as its raw
  payload and dequantized in shared memory), under its own plan
  (:func:`block_split_plan`).

Both kernels' attention body is ``csrc/decode_split.cuh``; the source notes
say what bounds them and how the design answers that. CPU
tensors run the plain versions beside them. The port keeps the logical
unpacked layouts: the TPU's token-pair packing for Dh < 128 and its
pair-grouped scales are tiling devices with no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from deepspeed_tpu_torch.ops import cuda_build, kernel_flops

_THREADS, _MAX_PER_THREAD = 128, 16   # csrc/decode_split.cuh block shape
_STAGE_ROWS = 64                      # csrc/decode_split.cuh kStageRows
_TC_HEAD_DIMS = (64, 128, 256)        # csrc/decode_split.cuh attend_tc widths
# pool storage code of csrc/block_decode_step.cu
_KV_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}


def _cc_rows(dh: int, itemsize: int) -> int:
    """Positions per copy batch of the CUDA-core body (decode_split.cuh
    ``cc_rows``): one batch of K or V rows within 16 KB, 8 to 64."""
    return min(64, max(8, 16384 // (dh * itemsize)))


def split_plan(b: int, hkv: int, s_max: int, sms: int, dh: int = 128,
               itemsize: int = 2):
    """``(chunk, n_splits)`` of the split attention over a contiguous cache,
    the fused decode step (kernel B, ``csrc/decode_step.cu``) and
    flash-decode at rep >= 2 (``csrc/flash_decode.cu``): positions per
    block and blocks along S, for a grid of (n_splits, hkv, b) blocks.

    On the tensor-core body (16-bit elements at Dh 64, 128 or 256) the
    smallest chunk is one 64-position stage, and it doubles while the grid
    at full S would hold more than one block per SM: the body's ring fits
    two, and a second wave cost more than the longer walk. On the
    CUDA-core body (f32, other head widths) the smallest chunk is one copy
    batch (``_cc_rows``), doubling while the grid would hold more than two
    blocks per SM. ``chip_smoke.py`` times these plans against fixed
    chunks (PERF.md). A function of the shapes only: the host never reads
    idx, and a row's result does not depend on the other slots'."""
    tc = itemsize == 2 and dh in _TC_HEAD_DIMS
    chunk, per_sm = (_STAGE_ROWS, 1) if tc else (_cc_rows(dh, itemsize), 2)
    while chunk < s_max and b * hkv * -(-s_max // chunk) > per_sm * sms:
        chunk *= 2
    return chunk, -(-s_max // chunk)


def block_split_plan(b: int, hkv: int, s_max: int, sms: int):
    """``(chunk, n_splits)`` of the block decode step (kernel C,
    ``csrc/block_decode_step.cu``, S = MB * bs): the smallest chunk is one
    64-position stage, and it doubles while the grid at full S would still
    hold four blocks per SM. Kernel C keeps these finer splits: its rows
    ran slower under :func:`split_plan` at every pool type, where kernel
    B's ran faster (``chip_smoke.py`` times both; PERF.md). A function of
    the shapes only."""
    chunk = _STAGE_ROWS
    while chunk < s_max and b * hkv * -(-s_max // (2 * chunk)) >= 4 * sms:
        chunk *= 2
    return chunk, -(-s_max // chunk)


def _split_scratch(b: int, hq: int, s_max: int, dh: int, plan, device):
    """``(ml, acc)``: with more than one split in ``plan`` (``(chunk,
    n_splits)``), the splits' f32 partials from ``torch.empty`` on the
    current stream (so a call replays in a CUDA graph), else ``None``s."""
    n_splits = plan[1]
    if n_splits == 1:
        return None, None
    return (torch.empty((b, hq, n_splits, 2), dtype=torch.float32, device=device),
            torch.empty((b, hq, n_splits, dh), dtype=torch.float32, device=device))


def supports(hq: int, hkv: int, s_max: int, dh: int, itemsize: int = 2) -> bool:
    """Shapes the CUDA kernel takes: whole GQA groups, 16-byte K/V rows,
    and a kv head's query group within one block's registers."""
    return (hkv > 0 and hq % hkv == 0 and s_max > 0
            and (dh * itemsize) % 16 == 0
            and (hq // hkv) * dh <= _THREADS * _MAX_PER_THREAD)


def _report(name: str, q, idx, s_max: int) -> None:
    """The decode step's products to the FLOPs profiler (ops/kernel_flops.py):
    the per-slot lengths are read only while it counts."""
    if kernel_flops.counting():
        b, _, hq, dh = q.shape
        kernel_flops.report(name, kernel_flops.decode_flops(hq, dh, idx, b,
                                                            s_max))


def _idx_vector(idx, b: int, device) -> torch.Tensor:
    """The per-slot index as a ``[B]`` long tensor; a 0-dim tensor is
    broadcast on its device, never read by the host."""
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
    s_max = k_full.shape[3]
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
    return _attend_plain(q, kl, vl, iv, sc), k_full, v_full


def _attend_plain(q, kl, vl, iv, sc: float) -> torch.Tensor:
    """The kernels' attention with their rounding points: q ``[B, 1, Hq,
    Dh]`` against ``kl``/``vl`` ``[B, Hkv, S, Dh]`` (the stored values, in
    the compute dtype) over positions ``<= iv[b]``; scores in f32 times
    ``sc``, probabilities rounded to the K/V dtype before P.V, the output
    divided by max(l, 1e-20) and cast once."""
    b, _, hq, dh = q.shape
    hkv, s_max = kl.shape[1], kl.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    s = torch.einsum("bkrd,bksd->bkrs", qg, kl.float()) * sc
    valid = torch.arange(s_max, device=q.device)[None, :] <= iv[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)
    pv = torch.einsum("bkrs,bksd->bkrd", p.to(vl.dtype).float(), vl.float())
    out = (pv / l.clamp_min(1e-20)[..., None]).to(q.dtype)
    return out.reshape(b, 1, hq, dh)


def _check_tensor(what: str, name: str, tns: torch.Tensor, dtype, device):
    if tns.device != device or tns.dtype != dtype:
        raise ValueError(f"{what}: {name} must be {dtype} on {device}, got "
                         f"{tns.dtype} on {tns.device}")
    if not tns.is_contiguous() or tns.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                         "aligned")


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
    idx:           python int (every slot), a 0-dim int32 tensor on the
                   same device (every slot; expanded to ``[B]`` there) or an
                   int32 ``[B]`` tensor of per-slot write positions / valid
                   lengths; a tensor is read by the kernel, never by the
                   host.

    Returns ``(attn [B, 1, Hq, Dh], k_full, v_full)``; the returned caches
    are the inputs, written in place."""
    if q.device.type == "cpu":
        _report("fused_decode_step", q, idx, k_full.shape[3])
        return kernel_flops.plain(fused_decode_step_plain, q, k_full, v_full,
                                  k_new, v_new, layer, idx, scale=scale)
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
        _check_tensor("fused_decode_step", name, tns, dtype, q.device)
    if isinstance(idx, torch.Tensor):
        if idx.ndim == 0 and idx.device == q.device and idx.dtype == torch.int32:
            idx = idx.reshape(1).expand(b).contiguous()
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
    chunk, n_splits = split_plan(b, hkv, s_max,
                                 cuda_build.sm_count(q.device.index or 0), dh,
                                 q.element_size())
    ml, acc = _split_scratch(b, hq, s_max, dh, (chunk, n_splits), q.device)
    err = lib.dst_fused_decode_step(
        q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), out.data_ptr(),
        None if ml is None else ml.data_ptr(),
        None if acc is None else acc.data_ptr(), idx_ptr, idx_scalar,
        int(layer), b, hq, hkv, s_max, dh, chunk, n_splits, sc,
        cuda_build.dtype_code(dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, err, "fused_decode_step")
    fused_decode_step.launches += 1
    _report("fused_decode_step", q, idx, s_max)
    return out, k_full, v_full


fused_decode_step.launches = 0


def supports_block(hq: int, hkv: int, block_size: int, dh: int,
                   itemsize: int = 2) -> bool:
    """Shapes the block decode kernel takes: whole GQA groups, pool rows of
    a multiple of 16 bytes (``itemsize`` is the pool's storage element
    size: 1 for int8/fp8 payloads), and a kv head's query group within one
    block's registers."""
    return (hkv > 0 and hq % hkv == 0 and block_size > 0
            and (dh * itemsize) % 16 == 0
            and (hq // hkv) * dh <= _THREADS * _MAX_PER_THREAD)


def fused_block_decode_step_plain(q, k_pool, v_pool, k_new, v_new,
                                  layer: int, idx, block_table, *,
                                  scale: Optional[float] = None):
    """Plain version of :func:`fused_block_decode_step`: the write through
    the table (overflow to the garbage row, quantize on store), the gather
    (dequantizing), then the attention with the kernel's rounding points
    over positions ``<= idx[b]`` (the new token is read back as its stored,
    dequantized image)."""
    from deepspeed_tpu_torch.ops.attention import (gather_block_kv,
                                                   pool_layer,
                                                   write_kv_blocks)

    b, _, _, dh = q.shape
    sc = float(scale) if scale is not None else dh ** -0.5
    iv = idx.to(device=q.device, dtype=torch.long).reshape(b)
    k_pool, v_pool = write_kv_blocks(k_pool, v_pool, k_new, v_new, layer, iv,
                                     block_table)
    kl = gather_block_kv(pool_layer(k_pool, layer), block_table, q.dtype)
    vl = gather_block_kv(pool_layer(v_pool, layer), block_table, q.dtype)
    return _attend_plain(q, kl, vl, iv, sc), k_pool, v_pool


def fused_block_decode_step(q: torch.Tensor, k_pool, v_pool,
                            k_new: torch.Tensor, v_new: torch.Tensor,
                            layer: int, idx: torch.Tensor,
                            block_table: torch.Tensor, *,
                            scale: Optional[float] = None):
    """One decode layer-step against the block pool.

    q:             [B, 1, Hq, Dh]   the new token's queries
    k_pool/v_pool: [L, N+1, Hkv, bs, Dh] pools in the compute dtype (row N
                   is the garbage row), or ``{"q": payload, "s": scales}``
                   dicts with an int8/fp8 payload of that shape and bf16
                   scales ``[L, N+1, Hkv, bs]``; updated in place
    k_new/v_new:   [B, 1, Hkv, Dh]  the new token's K/V (not yet written)
    layer:         python int
    idx:           int32 [B] per-slot write positions / valid lengths
    block_table:   int32 [B, MB]; both are read by the kernel, never by the
                   host.

    Returns ``(attn [B, 1, Hq, Dh], k_pool, v_pool)``; the returned pools
    are the inputs, written in place."""
    if q.device.type == "cpu":
        _report("fused_block_decode_step", q, idx,
                block_table.shape[1] * (k_pool["q"] if isinstance(k_pool, dict)
                                        else k_pool).shape[3])
        return kernel_flops.plain(fused_block_decode_step_plain, q, k_pool,
                                  v_pool, k_new, v_new, layer, idx,
                                  block_table, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_block_decode_step: unsupported device {q.device}")
    what = "fused_block_decode_step"
    b, t, hq, dh = q.shape
    if t != 1:
        raise ValueError(f"{what} is the single-token path")
    quant = isinstance(k_pool, dict)
    if quant != isinstance(v_pool, dict):
        raise ValueError(f"{what}: k_pool and v_pool must both be quantized "
                         "or both not")
    kq, vq = (k_pool["q"], v_pool["q"]) if quant else (k_pool, v_pool)
    nl, n_phys, hkv, bs, dh2 = kq.shape
    if dh2 != dh or vq.shape != kq.shape:
        raise ValueError(f"{what}: pools {tuple(kq.shape)} / {tuple(vq.shape)} "
                         f"vs q {tuple(q.shape)}")
    if k_new.shape != (b, 1, hkv, dh) or v_new.shape != k_new.shape:
        raise ValueError(f"{what}: k_new/v_new {tuple(k_new.shape)} != "
                         f"{(b, 1, hkv, dh)}")
    dtype = q.dtype
    store = kq.dtype
    if quant and store not in _KV_CODES:
        raise ValueError(f"{what}: quantized payload must be int8 or "
                         f"float8_e4m3fn, got {store}")
    if not quant and store != dtype:
        raise ValueError(f"{what}: pool dtype {store} != compute dtype {dtype}")
    if not supports_block(hq, hkv, bs, dh, kq.element_size()):
        raise ValueError(f"{what}: unsupported geometry hq={hq} hkv={hkv} "
                         f"bs={bs} dh={dh} pool {store}")
    if not 0 <= int(layer) < nl:
        raise ValueError(f"layer {layer} outside [0, {nl})")
    for name, tns in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        _check_tensor(what, name, tns, dtype, q.device)
    _check_tensor(what, "k_pool", kq, store, q.device)
    _check_tensor(what, "v_pool", vq, store, q.device)
    ks_ptr = vs_ptr = None
    if quant:
        for name, sc_t in (("k_pool['s']", k_pool["s"]),
                           ("v_pool['s']", v_pool["s"])):
            if sc_t.shape != kq.shape[:4]:
                raise ValueError(f"{what}: {name} {tuple(sc_t.shape)} != "
                                 f"{tuple(kq.shape[:4])}")
            _check_tensor(what, name, sc_t, torch.bfloat16, q.device)
        ks_ptr, vs_ptr = k_pool["s"].data_ptr(), v_pool["s"].data_ptr()
    if (idx.device != q.device or idx.dtype != torch.int32
            or idx.shape != (b,) or not idx.is_contiguous()):
        raise ValueError(f"{what}: idx must be an int32 [{b}] tensor on "
                         f"{q.device}, got {idx.dtype} {tuple(idx.shape)} on "
                         f"{idx.device}")
    if (block_table.device != q.device or block_table.dtype != torch.int32
            or block_table.ndim != 2 or block_table.shape[0] != b
            or not block_table.is_contiguous()):
        raise ValueError(f"{what}: block_table must be a contiguous int32 "
                         f"[{b}, MB] tensor on {q.device}, got "
                         f"{block_table.dtype} {tuple(block_table.shape)} on "
                         f"{block_table.device}")
    mb = block_table.shape[1]
    if bs > 1024 or mb * bs > 1 << 20:
        raise ValueError(f"{what}: block_size {bs} (at most 1024) x table width "
                         f"{mb} (at most 2^20 positions) is past the kernel's range")
    sc = float(scale) if scale is not None else dh ** -0.5
    lib = cuda_build.kernels()
    out = torch.empty((b, 1, hq, dh), dtype=dtype, device=q.device)
    chunk, n_splits = block_split_plan(b, hkv, mb * bs,
                                       cuda_build.sm_count(q.device.index or 0))
    ml, acc = _split_scratch(b, hq, mb * bs, dh, (chunk, n_splits), q.device)
    err = lib.dst_fused_block_decode_step(
        q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks_ptr, vs_ptr,
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
        None if ml is None else ml.data_ptr(),
        None if acc is None else acc.data_ptr(), idx.data_ptr(),
        block_table.data_ptr(), int(layer), b, hq, hkv, n_phys, bs, mb, dh,
        chunk, n_splits, sc, cuda_build.dtype_code(dtype),
        _KV_CODES[store] if quant else 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, err, what)
    fused_block_decode_step.launches += 1
    _report(what, q, idx, mb * bs)
    return out, k_pool, v_pool


fused_block_decode_step.launches = 0
