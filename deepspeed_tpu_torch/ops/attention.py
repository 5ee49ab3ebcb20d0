"""Attention ops of the PyTorch port (port of deepspeed_tpu/ops/attention.py:
the slot-cache and the block-pool paths).

The port always keeps the logical unpacked layouts: the stacked slot cache
``[L, B, Hkv, S, Dh]`` and the block pool ``[L, N+1, Hkv, bs, Dh]`` (or its
quantized ``{"q", "s"}`` form, serving/kv_quant.py). A single-token step
over the slot cache takes the route :func:`decode_route` names, the
reference's two gates: the wide-GQA flash-decode kernel
(ops/flash_decode.py) for a scalar index at batch 1 with a thin cache, else
the fused decode-step kernel (ops/decode_step.py). On a CUDA tensor that is
the kernel, whose wrapper raises on a geometry it does not take; on a CPU
tensor its plain version. Block-pool decode goes to the block decode-step
kernel the same way. Prefill blocks take the plain path on both devices:
an in-place cache write plus :func:`decode_attention`, as the JAX package
leaves them to XLA. Caches are updated in place and returned for the
reference's call shape.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from deepspeed_tpu_torch.ops.decode_step import (fused_block_decode_step,
                                                 fused_decode_step)
from deepspeed_tpu_torch.ops.flash_decode import flash_decode
from deepspeed_tpu_torch.serving.kv_quant import (is_quantized_pool,
                                                  kv_dequantize, kv_dtype_of,
                                                  kv_quantize, pool_payload)
from deepspeed_tpu_torch.utils.tree import tree_map

_F32_MIN = torch.finfo(torch.float32).min

# The reference's batch-1 gate (deepspeed_tpu/ops/attention.py:30-31) in the
# same unit: bytes of ONE layer's K cache at its full allocated length. A
# batch-1 step over a thinner cache leaves the fused step; the JAX package
# reads an environment override, the port keeps the constant.
_B1_FUSED_MIN_BYTES = 2 * 1024 * 1024


def _kv_pack_factor(dh: int) -> int:
    """The reference's token-pair packing factor (attention.py:69-78)."""
    return 1 if dh >= 128 or 128 % dh else 128 // dh


def scalar_index(idx) -> bool:
    """Whether a cache index is the scalar one (a python int, or a 0-dim
    tensor read on its device) rather than a per-slot ``[B]`` vector."""
    return not isinstance(idx, torch.Tensor) or idx.ndim == 0


def decode_route(b: int, t: int, hq: int, hkv: int, s: int, dh: int,
                 itemsize: int, scalar_idx: bool) -> str:
    """Which kernel takes a step of ``t`` query tokens over a ``[L, B, Hkv,
    S, Dh]`` slot cache of ``itemsize``-byte elements: ``"prefill"`` (t > 1,
    the plain write + :func:`decode_attention`), ``"flash_decode"`` or
    ``"fused"``. The reference's two gates, in its order:

    * the fused step (cached_attention, attention.py:154-171) needs the
      allocation the reference makes for it (token-pair packing for Dh <
      128, which it skips at batch 1 or an S not a multiple of 128), at
      batch 1 a K cache of at least ``_B1_FUSED_MIN_BYTES`` per layer, and
      its kernel's tiling (decode_step.supports: S % 128 == 0, Dh | 128 or
      128 | Dh);
    * otherwise flash-decode (decode_attention, :535-550) takes a scalar
      index, S % 128 == 0 and GQA rep >= 8.

    Where the reference would run its einsum (neither gate), the port runs
    the fused step (ROADMAP queue 3): the fused kernel takes those shapes,
    and a plain path on the card would be a second implementation to keep.
    """
    if t != 1:
        return "prefill"
    pack = _kv_pack_factor(dh)
    pair = pack if (b >= 2 and s % 128 == 0) else 1
    tiles = (hq % hkv == 0 and s % 128 == 0
             and (dh % 128 == 0 if dh >= 128 else 128 % dh == 0))
    if (pair == pack and tiles
            and (b >= 2 or hkv * s * dh * itemsize >= _B1_FUSED_MIN_BYTES)):
        return "fused"
    if scalar_idx and s % 128 == 0 and hq // hkv >= 8:
        return "flash_decode"
    return "fused"


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        scale: Optional[float] = None,
                        dropout_rate: float = 0.0,
                        dropout_rng: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """q [B, T, H, Dh], k/v [B, S, H, Dh]; logits in the input dtype, then
    softmax in f32, probabilities cast back before P.V (the JAX rounding).
    Causal masking aligns bottom-right (query t sees keys <= t + S - T).
    ``dropout_rate`` with a ``dropout_rng`` generator (on q's device) drops
    probabilities and rescales the kept ones by 1 / (1 - rate), as the
    reference; the random bits are torch's, not JAX's."""
    t, dh = q.shape[1], q.shape[3]
    s = k.shape[1]
    scale = scale if scale is not None else dh ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if causal:
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril(s - t)
        logits = logits.masked_fill(~mask, _F32_MIN)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and dropout_rng is not None:
        keep = torch.rand(probs.shape, generator=dropout_rng,
                          device=probs.device) < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate),
                            torch.zeros_like(probs))
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)


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
                     scale: Optional[float] = None, block_table=None):
    """One cached-attention layer step: write the new block's K/V at
    ``idx`` (a python int for a uniform batch, or a per-slot ``[B]`` int32
    tensor for continuous batching), attend, return
    ``(attn, k_full, v_full)``. Single-token steps take the kernel
    :func:`decode_route` names (its plain version on the CPU); prefill
    blocks take the write + einsum path.

    ``block_table`` (int32 ``[B, MB]``) switches to the block-paged mode:
    ``k_full``/``v_full`` are then the block pools (tensors or quantized
    ``{"q", "s"}`` dicts), ``idx`` is the per-slot ``[B]`` length vector, and
    logical position ``p`` of row ``b`` lives in pool block
    ``block_table[b, p // bs]``, row ``p % bs``."""
    if block_table is not None:
        return _block_cached_attention(q, k_full, v_full, k_new, v_new,
                                       layer, idx, block_table, scale=scale)
    if is_quantized_pool(k_full):
        raise ValueError(
            "quantized KV pools are block-paged only: cached_attention got a "
            "{'q','s'} cache without a block_table (serving must run with "
            "prefix_cache=True to use kv_dtype)")
    b, t, hq, dh = q.shape
    _, _, hkv, s_max, _ = k_full.shape
    route = decode_route(b, t, hq, hkv, s_max, dh, k_full.element_size(),
                         scalar_index(idx))
    if route == "fused":
        # the kernel (or its wrapper's ValueError) on CUDA, its plain
        # version on the CPU
        return fused_decode_step(q, k_full, v_full, k_new, v_new, layer, idx,
                                 scale=scale)
    k_full, v_full, kl, vl = write_kv_cache(k_full, v_full, k_new, v_new,
                                            layer, idx)
    if route == "flash_decode":
        return (flash_decode(q, kl, vl, idx, scale=scale), k_full, v_full)
    return decode_attention(q, kl, vl, idx, scale=scale), k_full, v_full


def write_kv_cache(k_full, v_full, k_new, v_new, layer: int, idx):
    """Write one block's new K/V ``[B, T, Hkv, Dh]`` into the stacked caches
    at ``(layer, idx)`` in place. A per-slot ``[B]`` idx writes row b's
    token j to position ``idx[b] + j`` and drops positions past the
    allocation (``mode="drop"``: an inactive slot's stale length may equal
    max_len); it moves only B x T rows (:func:`_write_slot_rows`). A scalar
    idx is one slice write whose start is clamped so the block fits
    (``dynamic_update_slice`` semantics); a 0-dim tensor idx is clamped and
    written on its device. Every form has a fixed shape, so none reads the
    index on the host. Returns ``(k_full, v_full, k_layer, v_layer)`` with
    ``[B, Hkv, S, Dh]`` views."""
    kl, vl = k_full[layer], v_full[layer]
    t = k_new.shape[1]
    s_max = k_full.shape[3]
    if isinstance(idx, torch.Tensor) and idx.ndim == 1:
        _write_slot_rows(kl, k_new.to(k_full.dtype), idx)
        _write_slot_rows(vl, v_new.to(v_full.dtype), idx)
    elif isinstance(idx, torch.Tensor):
        pos = (idx.to(torch.long).clamp(0, s_max - t)
               + torch.arange(t, device=idx.device))
        kl.index_copy_(2, pos, k_new.transpose(1, 2).to(k_full.dtype))
        vl.index_copy_(2, pos, v_new.transpose(1, 2).to(v_full.dtype))
    else:
        start = min(max(int(idx), 0), s_max - t)
        kl[:, :, start:start + t] = k_new.transpose(1, 2).to(k_full.dtype)
        vl[:, :, start:start + t] = v_new.transpose(1, 2).to(v_full.dtype)
    return k_full, v_full, kl, vl


def _write_slot_rows(lay: torch.Tensor, new: torch.Tensor, idx: torch.Tensor):
    """``lay`` ``[B, Hkv, S, Dh]``, in place: row b's new token j lands at
    position ``idx[b] + j``, and a position past the allocation is never
    written. Each row reads and writes one fixed window of ``min(T, S)``
    positions starting at ``clamp(idx[b], 0, S - min(T, S))``: a window
    position takes the new token that lands on it, else keeps its value.
    The window covers every position a new token lands on below S, so this
    equals a ``where`` over the whole layer, at B x T rows of traffic; the
    positions of one row are distinct, so the scatter is deterministic."""
    b, t = new.shape[0], new.shape[1]
    s_max = lay.shape[2]
    w = min(t, s_max)
    iv = idx.to(torch.long)
    pos = (iv.clamp(0, s_max - w)[:, None]
           + torch.arange(w, device=idx.device))                   # [B, W]
    j = pos - iv[:, None]                       # which new token lands there
    hit = ((j >= 0) & (j < t))[:, :, None, None]
    rows = torch.arange(b, device=idx.device)[:, None]
    src = torch.take_along_dim(new, j.clamp(0, t - 1)[:, :, None, None],
                               dim=1)                              # [B, W, Hkv, Dh]
    lay[rows, :, pos] = torch.where(hit, src, lay[rows, :, pos])


def write_slot_prefix(k_full, v_full, k_pref, v_pref, slot: int):
    """Copy a prefilled single-sequence prefix cache ``[L, 1, Hkv, T, Dh]``
    into rows ``0..T-1`` of slot ``slot`` of the persistent slot caches, in
    place. Rows past the request's true length hold pad-token garbage that
    the per-slot length masks until decode overwrites them."""
    t_b = k_pref.shape[3]
    k_full[:, slot:slot + 1, :, :t_b] = k_pref.to(k_full.dtype)
    v_full[:, slot:slot + 1, :, :t_b] = v_pref.to(v_full.dtype)
    return k_full, v_full


def extract_slot_kv(k_full, v_full, slot: int):
    """Slot ``slot``'s row pair of the slot caches as a batch-1 stacked
    cache ``[L, 1, Hkv, S, Dh]``: views, so the chunk prefill writes the
    slot in place through them, and the preemption swap-out copies them to
    the host."""
    return k_full[:, slot:slot + 1], v_full[:, slot:slot + 1]


def insert_slot_kv(k_full, v_full, k_row, v_row, slot: int):
    """Write a batch-1 row pair (what :func:`extract_slot_kv` gave, on any
    device: a pinned host row is copied without a sync) back into slot
    ``slot`` of the slot caches, in place: the preemption swap-in."""
    k_full[:, slot:slot + 1].copy_(k_row, non_blocking=True)
    v_full[:, slot:slot + 1].copy_(v_row, non_blocking=True)
    return k_full, v_full


def _bytes(leaf: torch.Tensor) -> torch.Tensor:
    """An fp8 payload as its bytes (the same bits; index kernels take them)."""
    if leaf.dtype == torch.float8_e4m3fn:
        return leaf.view(torch.uint8)
    return leaf


def gather_pool_blocks(k_pool, v_pool, table: torch.Tensor):
    """The contents of the pool blocks ``table`` ``[MB]`` names, ``[L, MB,
    ...]`` per pool leaf (payload and scales of a quantized pool alike, so a
    round trip moves the stored bytes): the preemption swap-out. Sentinel
    entries gather the garbage row, which the engine does not park."""
    tbl = table.to(torch.long)

    def g(leaf):
        return _bytes(leaf).index_select(1, tbl).view(leaf.dtype)

    return tree_map(g, k_pool), tree_map(g, v_pool)


def scatter_pool_blocks(k_pool, v_pool, k_blocks, v_blocks,
                        dst: torch.Tensor):
    """Write ``[L, MB, ...]`` block contents into the pool rows ``dst``
    ``[MB]`` names, in place: the preemption swap-in. Entries the restore
    skips name the garbage row, so the operands' shapes never vary with
    what is uploaded (which of several writes to the garbage row lands
    there does not matter)."""
    idx = dst.to(torch.long)

    def s(leaf, blk):
        _bytes(leaf).index_copy_(1, idx, _bytes(blk))

    tree_map(s, k_pool, k_blocks)
    tree_map(s, v_pool, v_blocks)
    return k_pool, v_pool


def pool_block_size(k_pool) -> int:
    """Tokens per block of a (possibly quantized) block pool
    ``[L, N+1, Hkv, bs, Dh]``."""
    return pool_payload(k_pool).shape[3]


def _write_rows(pool_layer: torch.Tensor, pb, wi, rows: torch.Tensor):
    """``pool_layer[pb, :, wi] = rows`` in place; fp8 payloads are written
    through their byte view (the same bits)."""
    if pool_layer.dtype == torch.float8_e4m3fn:
        pool_layer, rows = pool_layer.view(torch.uint8), rows.view(torch.uint8)
    pool_layer[pb, :, wi] = rows.to(pool_layer.dtype)


def write_kv_blocks(k_pool, v_pool, k_new, v_new, layer: int, idx,
                    block_table):
    """Scatter one step's new K/V ``[B, T, Hkv, Dh]`` into the block pools in
    place through the per-slot block table: row b's token j lands at
    logical position ``idx[b] + j``, i.e. pool block
    ``block_table[b, pos // bs]``, row ``pos % bs``. Positions past the table
    width go to the pool's last (garbage) row, never to a real block.

    A quantized ``{"q", "s"}`` pool is quantized on store: each new token's
    per-head scale is computed here (serving/kv_quant.kv_quantize) and
    scatters beside its payload. Returns ``(k_pool, v_pool)``."""
    payload = pool_payload(k_pool)
    n_phys, bs = payload.shape[1], payload.shape[3]
    t = k_new.shape[1]
    mb = block_table.shape[1]
    pos = idx.to(torch.long)[:, None] + torch.arange(t, device=idx.device)
    jb = pos // bs
    pb = torch.gather(block_table.to(torch.long), 1, jb.clamp(0, mb - 1))
    pb = torch.where(jb < mb, pb, n_phys - 1)     # overflow -> garbage row
    wi = pos % bs
    if is_quantized_pool(k_pool):
        kv_dtype = kv_dtype_of(payload)
        for pool, new in ((k_pool, k_new), (v_pool, v_new)):
            q, s = kv_quantize(new, kv_dtype)     # [B,T,Hkv,Dh], [B,T,Hkv]
            _write_rows(pool["q"][layer], pb, wi, q)
            pool["s"][layer][pb, :, wi] = s
    else:
        _write_rows(k_pool[layer], pb, wi, k_new)
        _write_rows(v_pool[layer], pb, wi, v_new)
    return k_pool, v_pool


def gather_block_kv(pool_layer, block_table, out_dtype=None) -> torch.Tensor:
    """Per-layer slot view of a block pool: gather each row's blocks
    ``[N+1, Hkv, bs, Dh] -> [B, Hkv, MB * bs, Dh]`` (the shape
    :func:`decode_attention` expects). Unallocated table entries read the
    garbage row: finite values, always masked by the per-slot length. A
    quantized ``{"q", "s"}`` layer gathers payload and scales and
    dequantizes into ``out_dtype`` (required for it)."""
    b, mb = block_table.shape
    tbl = block_table.to(torch.long).clamp(0, pool_payload(pool_layer).shape[0] - 1)
    if is_quantized_pool(pool_layer):
        if out_dtype is None:
            raise ValueError("gather_block_kv on a quantized layer needs out_dtype")
        ql, sl = pool_layer["q"], pool_layer["s"]    # [N,Hkv,bs,Dh], [N,Hkv,bs]
        _, hkv, bs, dh = ql.shape
        kb = ql[tbl].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, dh)
        sb = sl[tbl].permute(0, 2, 1, 3).reshape(b, hkv, mb * bs)
        return kv_dequantize(kb, sb, out_dtype)
    _, hkv, bs, dh = pool_layer.shape
    kb = pool_layer[tbl].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, dh)
    return kb if out_dtype is None else kb.to(out_dtype)


def pool_layer(pool, layer: int):
    """Layer ``layer`` of a block pool (a view; dicts stay dicts)."""
    if is_quantized_pool(pool):
        return {"q": pool["q"][layer], "s": pool["s"][layer]}
    return pool[layer]


def _block_cached_attention(q, k_pool, v_pool, k_new, v_new, layer: int,
                            idx, block_table, *, scale: Optional[float] = None):
    """Block-paged cached attention (see :func:`cached_attention`): write
    the new tokens' K/V through the block table, then attend each row over
    its own gathered blocks. Single-token decode on CUDA routes to the
    block decode kernel, which reads each slot's valid blocks straight from
    the pool; everything else (suffix prefill, CPU) takes the write +
    gather + :func:`decode_attention` path. Both attend over the
    quantize-dequantize image of the new token, the value later steps
    read."""
    if not (isinstance(idx, torch.Tensor) and idx.ndim == 1):
        raise ValueError("block-paged attention needs the per-slot [B] "
                         "length tensor")
    if q.shape[1] == 1 and q.device.type == "cuda":
        return fused_block_decode_step(q, k_pool, v_pool, k_new, v_new, layer,
                                       idx, block_table, scale=scale)
    k_pool, v_pool = write_kv_blocks(k_pool, v_pool, k_new, v_new, layer, idx,
                                     block_table)
    kl = gather_block_kv(pool_layer(k_pool, layer), block_table, q.dtype)
    vl = gather_block_kv(pool_layer(v_pool, layer), block_table, q.dtype)
    return decode_attention(q, kl, vl, idx, scale=scale), k_pool, v_pool


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
        if not isinstance(cache_index, torch.Tensor):
            cache_index = int(cache_index)
        valid = pos[None, :] <= (cache_index + tt)[:, None]   # [T, S]
    logits = logits.masked_fill(~valid, _F32_MIN)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkrts,bksd->btkrd", probs, v_cache)
    return out.reshape(b, t, hq, dh)
