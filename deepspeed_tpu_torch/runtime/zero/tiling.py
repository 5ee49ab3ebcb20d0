"""Memory-tiled linear algebra (port of deepspeed_tpu/runtime/zero/tiling.py).

``tiled_linear`` computes ``x @ w (+ b)`` over a grid of weight tiles, so no
full-size intermediate of the product exists at once (the reference
DeepSpeed's TiledLinear). ``chunked_cross_entropy`` is the tied-LM-head
softmax cross-entropy without the ``[B, T, V]`` logits: a
``torch.autograd.Function`` that walks the sequence in chunks in the
forward and recomputes each chunk's logits in the backward, so peak logit
memory is ``B * chunk * V`` in both passes (a Python loop under autograd
would keep every chunk's logits for the backward).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def tiled_linear(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *, out_tiles: int = 1,
                 in_tiles: int = 1) -> torch.Tensor:
    """``y = x @ w (+ b)`` with the output and/or contraction dim in tiles.

    x: ``[..., K]``, w: ``[K, N]`` → ``[..., N]``. ``in_tiles`` must divide
    K, ``out_tiles`` must divide N. Tiles of the contraction are summed in
    f32 (their products from the storage-dtype operands, as one dense
    product accumulates) and cast to x's dtype once."""
    k, n = w.shape
    assert k % in_tiles == 0, (k, in_tiles)
    assert n % out_tiles == 0, (n, out_tiles)
    kt, nt = k // in_tiles, n // out_tiles

    def out_tile(j):
        wj = w[:, j * nt:(j + 1) * nt]
        if in_tiles == 1:
            return x @ wj.to(x.dtype)
        acc = None
        for i in range(in_tiles):
            xi = x[..., i * kt:(i + 1) * kt]
            wij = wj[i * kt:(i + 1) * kt].to(x.dtype)
            # storage-dtype operands, f32 sum: products of bf16/f16 values
            # are exact in f32
            part = xi.float() @ wij.float()
            acc = part if acc is None else acc + part
        return acc.to(x.dtype)

    y = torch.cat([out_tile(j) for j in range(out_tiles)], dim=-1)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _chunks(t: int, chunk: int):
    """``(start, stop)`` of each chunk; a non-divisible tail is one smaller
    chunk."""
    return [(s, min(s + chunk, t)) for s in range(0, t, chunk)]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) of compute-dtype values, the products summed in f32
    and the result f32. On the card a 16-bit product goes to the tensor
    cores with an f32 output: a 16-bit output lets cuBLAS sum split-K
    partials in 16 bits, which loses most of a sum that cancels, as
    ``softmax - onehot`` over the vocabulary does. Elsewhere the same
    products come from f32 copies (16-bit products are exact in f32)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_logits(h: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """f32 logits of one chunk, rounded through the compute dtype as the
    reference's ``einsum(h, embed.astype(h.dtype)).astype(f32)``."""
    return torch.einsum("bcd,vd->bcv", h, embed.to(h.dtype)).float()


class _ChunkedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, embed, labels, chunk: int, ignore_index: int):
        loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
        count = torch.zeros((), dtype=torch.int64, device=hidden.device)
        for s, e in _chunks(hidden.shape[1], chunk):
            logits = _chunk_logits(hidden[:, s:e], embed)
            lab = labels[:, s:e]
            valid = lab != ignore_index
            safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
            nll = torch.logsumexp(logits, -1) - torch.gather(
                logits, -1, safe[..., None])[..., 0]
            loss_sum = loss_sum + torch.where(valid, nll, 0.0).sum()
            count = count + valid.sum()
            del logits, nll
        count = count.clamp_min(1)  # match base.cross_entropy_loss exactly
        ctx.save_for_backward(hidden, embed, labels, count)
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        ctx.mark_non_differentiable(count)
        return loss_sum / count, count

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        hidden, embed, labels, count = ctx.saved_tensors
        g = g_loss.float() / count
        need_h, need_e = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dh = torch.empty_like(hidden) if need_h else None
        de = torch.zeros(embed.shape, dtype=torch.float32,
                         device=embed.device) if need_e else None
        w = embed.to(hidden.dtype)
        for s, e in _chunks(hidden.shape[1], ctx.chunk):
            h = hidden[:, s:e]
            logits = _chunk_logits(h, embed)
            lab = labels[:, s:e]
            valid = lab != ctx.ignore_index
            safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
            # d nll / d logits = softmax - onehot(label), on scored tokens
            dl = torch.softmax(logits, -1)
            dl.scatter_add_(-1, safe[..., None],
                            torch.full_like(safe[..., None], -1.0,
                                            dtype=dl.dtype))
            dl = dl * (valid[..., None] * g)
            del logits
            # the cotangent of the f32 cast: rounded to the compute dtype
            dl = dl.to(h.dtype).reshape(-1, embed.shape[0])
            if need_h:
                # summed in f32 and rounded once, as one dense product
                dh[:, s:e] = _mm_f32(dl, w).reshape(h.shape).to(h.dtype)
            if need_e:
                # summed in f32 over all chunks, and rounded once
                de += _mm_f32(dl.t(), h.reshape(-1, h.shape[-1]))
            del dl
        if need_e:
            de = de.to(embed.dtype)
        return dh, de, None, None, None


def chunked_cross_entropy(hidden: torch.Tensor, embed: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 128,
                          ignore_index: int = -100
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tied-LM-head softmax cross-entropy without ``[B, T, V]`` logits.

    hidden: ``[B, T, D]``; embed: ``[V, D]`` (the tied embedding); labels:
    ``[B, T]``. Returns ``(mean loss over scored tokens, scored-token
    count)`` with models/base.cross_entropy_loss's semantics (label ==
    ``ignore_index`` skipped)."""
    chunk = min(chunk, hidden.shape[1])
    return _ChunkedCrossEntropy.apply(hidden, embed, labels, chunk,
                                      ignore_index)
