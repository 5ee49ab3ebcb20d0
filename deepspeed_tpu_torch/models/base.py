"""Shared model layers of the PyTorch port (port of
deepspeed_tpu/models/base.py: the layers of the serving and training paths,
and the attention dispatch ``sp_attention``).

Weights may be weight-only int8 dicts ``{"__q__": int8, "__scale__": f32}``
exactly as in the JAX package. A layer-stacked int8 weight stays whole
under :func:`layer_view` (a plain ``"__layer__"`` int is attached), so the
int8 kernel offsets into the stacked tensor and nothing is copied.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.ops.int8_matmul import MAX_ROWS, int8_matmul_dma

ATTN_IMPLS = ("dense", "flash", "ring", "ring_flash", "ulysses")
SEQUENCE_PARALLEL_IMPLS = ("ring", "ring_flash", "ulysses")


def sp_attention(attn_impl: str, q, k, v, *, causal: bool = True):
    """Dispatch to the non-dense attention ops: ``"flash"`` is the flash
    attention kernels (ops/flash_attention.py); the sequence-parallel forms
    are not ported yet."""
    if attn_impl == "flash":
        from deepspeed_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal)
    if attn_impl in SEQUENCE_PARALLEL_IMPLS:
        raise NotPortedError(f"attn_impl={attn_impl!r} (sequence-parallel "
                             "attention) is not ported to the PyTorch "
                             "package yet")
    raise ValueError(f"unknown attn_impl {attn_impl!r}")


def layer_norm(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def _is_qweight(w) -> bool:
    return isinstance(w, dict) and "__q__" in w


def qdot(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """einsum whose weight may be weight-only int8.

    Decode-width activations (<= 32 rows) of an int8 weight on a CUDA
    tensor go to the int8 weight-streaming kernel (the JAX package's
    routing condition, models/base.py:111-113, with "backend is tpu" read
    as "tensor on CUDA"); the kernel keeps the per-column scale in f32 and
    casts once. Every other int8 call takes the einsum-dequant path: the
    int8 weight cast to x's dtype, the matmul, then the scale multiplied in
    x's dtype."""
    if not _is_qweight(w):
        return torch.einsum(eq, x, w.to(x.dtype))
    q, s = w["__q__"], w["__scale__"]
    layer = w.get("__layer__")
    stacked = layer is not None and q.ndim == 3
    d_in, e_out = q.shape[-2], q.shape[-1]
    lhs, rhs = eq.replace(" ", "").split("->")
    xs, ws = lhs.split(",")
    std_form = len(ws) == 2 and ws[0] == xs[-1] and rhs == xs[:-1] + ws[1]
    n_rows = math.prod(x.shape[:-1])
    if (std_form and (q.ndim == 2 or stacked) and n_rows <= MAX_ROWS
            and d_in % 128 == 0 and e_out % 128 == 0
            and x.device.type == "cuda"):
        out2d = int8_matmul_dma(x.reshape(n_rows, d_in).contiguous(), q, s,
                                layer if stacked else None)
        return out2d.reshape(*x.shape[:-1], e_out)
    if stacked:
        q, s = q[layer], s[layer]
    out = torch.einsum(eq, x, q.to(x.dtype))
    return out * s.reshape((1,) * (out.ndim - 1) + (-1,)).to(x.dtype)


def embed_tokens(wte, input_ids, dtype):
    """Token-embedding gather; an int8 table with per-row scales dequantizes
    exactly per row after the gather."""
    if _is_qweight(wte):
        q, s = wte["__q__"], wte["__scale__"]
        return q[input_ids].to(dtype) * s.reshape(-1)[input_ids][..., None].to(dtype)
    return wte.to(dtype)[input_ids]


def tied_logits(hidden, wte):
    """Tied LM head ``[.., D] @ [V, D]^T``; an int8 table's per-row scale
    multiplies the output logit column."""
    if _is_qweight(wte):
        q, s = wte["__q__"], wte["__scale__"]
        out = torch.einsum("btd,vd->btv", hidden, q.to(hidden.dtype))
        return out * s.reshape(-1).to(hidden.dtype)
    return torch.einsum("btd,vd->btv", hidden, wte.to(hidden.dtype))


def cache_positions(index, t: int, device=None):
    """Query positions for a cache step: ``[t]`` for a scalar index (a python
    int, or a 0-dim tensor that stays on its device), ``[B, t]`` for a
    per-slot ``[B]`` tensor."""
    if isinstance(index, torch.Tensor):
        pos = index.to(torch.long)
        ar = torch.arange(t, device=index.device)
        return pos[:, None] + ar if index.ndim == 1 else pos + ar
    return int(index) + torch.arange(t, device=device)


def layer_view(blocks, i: int):
    """Per-layer view of a layer-stacked block dict: tensors are indexed
    (a view, no copy); int8 weight dicts stay whole with ``"__layer__"``."""
    out = {}
    for k, v in blocks.items():
        if _is_qweight(v):
            out[k] = {"__q__": v["__q__"], "__scale__": v["__scale__"],
                      "__layer__": i}
        elif isinstance(v, dict):
            out[k] = layer_view(v, i)
        else:
            out[k] = v[i]
    return out


def unbind_layers(blocks):
    """The layers of a layer-stacked block dict of tensors, as a list of
    per-layer dicts made by one ``unbind`` per weight. Autograd then stacks
    each weight's gradient once, where per-layer indexing
    (:func:`layer_view`) materializes and adds a full-size gradient for
    every layer (L full-size passes per weight per backward)."""
    names = list(blocks)
    return [dict(zip(names, ws))
            for ws in zip(*(blocks[n].unbind(0) for n in names))]


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Token-level CE in f32 with masking; returns (mean_loss, n_valid)."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    nll = (logz - ll) * valid.float()
    n = valid.sum().clamp_min(1)
    return nll.sum() / n, n


def make_causal_lm_batch(input_ids):
    """inputs/labels from one token stream: predict token t+1 from <=t."""
    return {"input_ids": input_ids[:, :-1], "labels": input_ids[:, 1:]}
