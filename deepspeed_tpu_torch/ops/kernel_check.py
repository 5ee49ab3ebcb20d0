"""Inputs and comparisons for holding the block decode kernel against its
plain version (ops/decode_step.py), shared by ``chip_smoke.py`` and the
card tests (tests/test_torch_cuda_kernels.py).

Pools are ``[L, N+1, Hkv, bs, Dh]`` in the compute type, or ``{"q", "s"}``
int8/fp8 pools quantized from random values (serving/kv_quant.py). Row
``N`` is the garbage row: inactive slots on sentinel tables may all write
it at once, in no fixed order, so comparisons leave it out.
"""

from __future__ import annotations

import torch

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
