"""Inputs and comparisons for holding kernels against their plain versions,
shared by ``chip_smoke.py`` and the card tests
(tests/test_torch_cuda_kernels.py): the block decode kernel
(ops/decode_step.py), the flash attention kernels
(ops/flash_attention.py) and the block-sparse attention kernels
(ops/sparse_attention/block_sparse.py).

Pools are ``[L, N+1, Hkv, bs, Dh]`` in the compute type, or ``{"q", "s"}``
int8/fp8 pools quantized from random values (serving/kv_quant.py). Row
``N`` is the garbage row: inactive slots on sentinel tables may all write
it at once, in no fixed order, so comparisons leave it out.

Flash and block-sparse outputs are compared row by row (:func:`rel_err`).
"""

from __future__ import annotations

import numpy as np
import torch

from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import (
    block_sparse_bwd_dkv_plain, block_sparse_bwd_dq_plain, work_list)
from deepspeed_tpu_torch.serving.kv_quant import kv_quantize


def random_pool(g: torch.Generator, layers: int, nblk: int, hkv: int,
                bs: int, dh: int, dtype, kv=None):
    """A pool of ``nblk`` real blocks plus the garbage row, from ``g``."""
    x = torch.randn((layers, nblk + 1, hkv, bs, dh), generator=g,
                    device=g.device).to(dtype)
    if kv is None:
        return x
    q, s = kv_quantize(x, kv)
    return {"q": q, "s": s}


def block_step_inputs(dev, dtype, kv, b: int, hq: int, hkv: int, nblk: int,
                      bs: int, mb: int, dh: int, layers: int = 2,
                      seed: int = 0):
    """``(g, q, k_pool, v_pool, k_new, v_new, table)`` for one block decode
    step: slot ``i`` names pool blocks ``perm[i*mb:(i+1)*mb]`` of a random
    permutation, the last slot names the garbage row only (an inactive
    slot). ``g`` is the generator, for more pools of the same kind."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    perm = torch.randperm(nblk, generator=g, device=dev).to(torch.int32)
    table = torch.full((b, mb), nblk, dtype=torch.int32, device=dev)
    for i in range(b - 1):
        table[i] = perm[i * mb:(i + 1) * mb]
    q, kn, vn = rnd(b, 1, hq, dh), rnd(b, 1, hkv, dh), rnd(b, 1, hkv, dh)
    kp = random_pool(g, layers, nblk, hkv, bs, dh, dtype, kv)
    vp = random_pool(g, layers, nblk, hkv, bs, dh, dtype, kv)
    return g, q, kp, vp, kn, vn, table


def clone_pool(pool):
    if isinstance(pool, dict):
        return {k: v.clone() for k, v in pool.items()}
    return pool.clone()


def real_rows_equal(a, b) -> bool:
    """Pools equal bit for bit (payload and scales) in every row but the
    garbage row."""
    if isinstance(a, dict):
        return all(real_rows_equal(a[k], b[k]) for k in ("q", "s"))
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a[:, :-1].contiguous().view(view),
                       b[:, :-1].contiguous().view(view))


def capture_graph(fn):
    """``(graph, outs)``: ``fn()`` captured in a CUDA graph after one
    warm-up call on a side stream (the kernel built and its scratch sized
    off the capture). ``outs`` is what the captured call returned; each
    replay writes it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    return graph, outs


def graph_replay(fn):
    """The tensors ``fn()`` returns, as one replay of its CUDA graph writes
    them (zeroed before the replay, so no bit comes from elsewhere)."""
    graph, outs = capture_graph(fn)
    for x in outs:
        x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return outs


def flash_inputs(dev, dtype, bh: int, tq: int, dh: int, tk=None, seed: int = 0):
    """``(q, k, v, dout)`` flat ``[BH, T, Dh]`` operands from a seeded
    generator: q and dout over ``tq`` rows, k and v over ``tk`` (default
    ``tq``)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(t):
        return torch.randn((bh, t, dh), generator=g, device=dev).to(dtype)

    return rnd(tq), rnd(tk or tq), rnd(tk or tq), rnd(tq)


def flash_delta(dout, out):
    """rowsum(dO * O) in f32, ``[BH, T, 1]`` (the backward's plain input)."""
    return (dout.float() * out.float()).sum(-1, keepdim=True)


def masked_row_layout(h: int, nb: int):
    """A bidirectional ``[h, nb, nb]`` layout whose query block 1 sees only
    key block 2: under ``causal=True`` its rows see no key at all (output
    0, lse -1e30). Every other block sees key block 0 and itself."""
    layout = np.eye(nb, dtype=bool)[None].repeat(h, 0)
    layout[:, :, 0] = True
    layout[:, 1, :] = False
    layout[:, 1, 2] = True
    return layout


def rel_err(out, ref) -> float:
    """The worst row's error as a share of that row's own scale, in f32: the
    max over rows (the last dim: a query row of O and dQ, a key row of dK
    and dV) of ``max |out - ref| / max(max |ref|, rms(ref))``, where rms is
    over the whole tensor.

    Normalising per row keeps the bound tight where attention outputs are
    small: under causal masking row i of O averages about i + 1 values, so
    late rows are many times smaller than row 0 (a copy of v[0]), and one
    bound relative to the tensor's max would pass a late tile wrong by its
    own typical size. The rms floor is the scale below which a row is held
    to an absolute bound: a row that is zero up to f32 rounding (dQ of row 0
    under causal masking, whose one dS entry is p (dp - delta) with p = 1
    and dp = delta) must not turn that rounding into a large share, at the
    f32 kernels' 1e-4 as at bf16's 2e-2."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    floor = ref.square().mean().sqrt().clamp_min(1e-30)
    return (err / ref.abs().amax(-1).clamp_min(floor)).max().item()


def _part_luts(lut: np.ndarray, counts: np.ndarray, part: int, drop=()):
    """The table ``lut [H, nb, width]`` cut as :func:`block_sparse.work_list`
    cuts it: one ``[H, nb, part]`` table per part index, each line holding
    that part's entries (-1 elsewhere). ``drop`` lists ``(line, part index)``
    pairs left out (line = h * nb + block)."""
    h, nb, width = lut.shape
    flat = lut.reshape(h * nb, width)
    items = work_list(counts, part)[0]
    for p in range(-(-width // part)):
        lut_p = np.full((h * nb, part), -1, dtype=np.int32)
        for line, first, count, _ in items:
            if first == p * part and (line, p) not in drop:
                lut_p[line, :count] = flat[line, first:first + count]
        yield lut_p.reshape(h, nb, part)


def dq_by_parts(qf, kf, vf, dof, lse, delta, luts, *, block: int,
                causal: bool, part: int, drop=()):
    """dQ as the dQ kernel sums it from its work list (block_sparse.work_list
    over the rows, ``part`` entries per item at most): each part's
    contribution from the plain version in f32 (which scales each part,
    where the kernel's merge scales their sum: an f32 rounding apart), the
    parts of a row summed in part order, rounded once to ``qf``'s dtype.
    ``drop`` lists ``(row, part index)`` pairs left out, as a kernel that
    lost one partial would (row = h * nb + query block)."""
    f32 = [x.float() for x in (qf, kf, vf, dof)]
    dq = None
    for lut_p in _part_luts(luts.lut_q.cpu().numpy(), luts.cnt_q.cpu().numpy(),
                            part, drop):
        p = block_sparse_bwd_dq_plain(
            *f32, lse, delta,
            luts._replace(lut_q=torch.from_numpy(lut_p).to(qf.device)),
            block=block, causal=causal)
        dq = p if dq is None else dq + p
    return dq.to(qf.dtype)


def dkv_by_parts(qf, kf, vf, dof, lse, delta, luts, *, block: int,
                 causal: bool, part: int, drop=()):
    """dK and dV as the dK/dV kernel sums them from its work list
    (block_sparse.work_list over the columns, ``part`` entries per item at
    most): each part's contribution from the plain version in f32, the
    parts of a column summed in part order, rounded once to ``kf``'s dtype.
    ``drop`` lists ``(column, part index)`` pairs left out, as a kernel that
    lost one partial would (column = h * nb + key block)."""
    f32 = [x.float() for x in (qf, kf, vf, dof)]
    dk = dv = None
    for lut_p in _part_luts(luts.lut_k.cpu().numpy(), luts.cnt_k.cpu().numpy(),
                            part, drop):
        pk, pv = block_sparse_bwd_dkv_plain(
            *f32, lse, delta,
            luts._replace(lut_k=torch.from_numpy(lut_p).to(qf.device)),
            block=block, causal=causal)
        dk, dv = (pk, pv) if dk is None else (dk + pk, dv + pv)
    return dk.to(kf.dtype), dv.to(vf.dtype)
