"""Parity of the port's block-table decode step
(deepspeed_tpu_torch/ops/decode_step.fused_block_decode_step) with the JAX
package's.

On the CPU the port runs its plain version; the JAX side runs its Pallas
block kernel in interpret mode, as tests/unit/serving runs it. Inputs are
made once with numpy and handed to both through a permuted block table. The
JAX pool is token-pair packed for Dh < 128 (a free row-major reshape of the
port's logical ``[L, N+1, Hkv, bs, Dh]``), and a quantized JAX pool keeps its
scales pair-grouped: ``kv_pool_from_numpy`` maps both to the port's layout.

Tolerances: written pools (payload and scales) bit-identical. Attention in
bf16 within atol 2e-2 + rtol 2e-2: both sum bf16 products in f32 and round
the probabilities to bf16 before P.V, but the kernel takes its running max
per block and the plain version over the whole row, so a probability may
round one bf16 ulp apart (2^-7 ~ 0.008 at |x| ~ 1). Attention in f32 within
2e-5 (the JAX package's own kernel-vs-einsum bound): only the summation
order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import _block_cached_attention
from deepspeed_tpu.ops.decode_step import \
    fused_block_decode_step as jax_fused_block_decode_step
from deepspeed_tpu.serving.kv_quant import kv_quantize
from deepspeed_tpu_torch.inference.weights import kv_pool_from_numpy
from deepspeed_tpu_torch.ops.decode_step import (fused_block_decode_step,
                                                 supports_block)

BF16_TOL, F32_TOL = 2e-2, 2e-5


def _np(a):
    return np.asarray(a.float() if a.dtype == torch.bfloat16 else a)


def _assert_pools_equal(port_pool, jax_pool, dh):
    want = kv_pool_from_numpy(jax.device_get(jax_pool), dh, "cpu")
    if isinstance(want, dict):
        assert torch.equal(port_pool["q"].view(torch.uint8),
                           want["q"].view(torch.uint8))
        assert torch.equal(port_pool["s"].view(torch.int16),
                           want["s"].view(torch.int16))
    else:
        assert torch.equal(port_pool, want)


@pytest.mark.parametrize("b,l,hq,hkv,dh,bs,mb", [
    (2, 2, 4, 4, 64, 16, 4),    # MHA, JAX pool token-pair packed
    (2, 2, 8, 2, 128, 16, 4),   # GQA rep 4, Dh 128
    (1, 2, 4, 4, 64, 32, 2),    # one row, bigger blocks
])
def test_bf16_pool_matches_jax_kernel(b, l, hq, hkv, dh, bs, mb):
    rng = np.random.RandomState(1)
    pair = 128 // dh if dh < 128 else 1
    n_phys = b * mb + 1
    table = rng.permutation(b * mb).reshape(b, mb).astype(np.int32)
    idx = np.asarray([bs - 1, mb * bs - 1][:b] if b > 1 else [bs + 3],
                     np.int32)                   # a block edge, the last row
    ku, vu = (rng.randn(l, n_phys, hkv, bs, dh) for _ in range(2))
    q, kn, vn = (rng.randn(b, 1, h, dh) for h in (hq, hkv, hkv))
    packed = (l, n_phys, hkv, bs // pair, dh * pair)

    def j(a):
        return jnp.asarray(a, jnp.bfloat16)

    ja, jk, jv = jax_fused_block_decode_step(
        j(q), j(ku).reshape(packed), j(vu).reshape(packed), j(kn), j(vn),
        jnp.int32(l - 1), jnp.asarray(idx), jnp.asarray(table),
        interpret=True)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    tk, tv = t(ku), t(vu)
    ta, tk2, tv2 = fused_block_decode_step(
        t(q), tk, tv, t(kn), t(vn), l - 1, torch.from_numpy(idx),
        torch.from_numpy(table))
    assert tk2 is tk and tv2 is tv               # written in place
    _assert_pools_equal(tk, jk, dh)
    _assert_pools_equal(tv, jv, dh)
    np.testing.assert_allclose(_np(ta), np.asarray(ja, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("kv_dtype,hq,hkv,dh", [
    ("int8", 4, 4, 64),    # MHA, JAX pool pair 2
    ("fp8", 4, 4, 64),
    ("int8", 8, 2, 64),    # GQA rep 4
    ("int8", 2, 2, 128),   # pair 1
])
def test_quantized_pool_matches_jax_kernel(kv_dtype, hq, hkv, dh):
    """f32 compute over an int8/fp8 pool (random rows quantized by the JAX
    quantizer, scales pair-grouped as the JAX pool keeps them): one decode
    step on both sides from the same pool."""
    rng = np.random.RandomState(3)
    l, mb, b = 2, 3, 2
    bs = 16 if dh == 64 else 8
    pair = 2 if dh == 64 else 1
    n_phys = b * mb + 1

    def pool():
        q, s = kv_quantize(jnp.asarray(rng.randn(l, n_phys, hkv, bs, dh),
                                       jnp.float32), kv_dtype)
        grouped = jnp.moveaxis(s.reshape(l, n_phys, hkv, bs // pair, pair),
                               -1, -2)
        return {"q": q.reshape(l, n_phys, hkv, bs // pair, dh * pair),
                "s": grouped}

    jk0, jv0 = pool(), pool()
    table = jnp.asarray(rng.permutation(b * mb).reshape(b, mb), jnp.int32)
    idx = jnp.asarray([bs + 1, 2 * bs + 3], jnp.int32)
    q, kn, vn = (jnp.asarray(rng.randn(b, 1, h, dh), jnp.float32)
                 for h in (hq, hkv, hkv))
    tk = kv_pool_from_numpy(jax.device_get(jk0), dh, "cpu")
    tv = kv_pool_from_numpy(jax.device_get(jv0), dh, "cpu")
    ja, jk, jv = jax_fused_block_decode_step(q, jk0, jv0, kn, vn, 1, idx,
                                             table, interpret=True)

    def t(a):
        return torch.from_numpy(np.array(a))

    ta, _, _ = fused_block_decode_step(t(q), tk, tv, t(kn), t(vn), 1,
                                       t(idx), t(table))
    _assert_pools_equal(tk, jk, dh)
    _assert_pools_equal(tv, jv, dh)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=F32_TOL,
                               rtol=F32_TOL)


def test_overflow_write_goes_to_the_garbage_row_as_jax_einsum():
    """idx == MB * bs (a position past the table width): the write lands in
    the garbage row and the slot attends over its MB * bs positions. The TPU
    kernel clamps that write into the slot's last block instead, so the
    reference is the JAX einsum path (write_kv_blocks + gather)."""
    rng = np.random.RandomState(4)
    b, l, hq, hkv, dh, bs, mb = 3, 2, 8, 2, 128, 16, 3
    n_phys = b * mb + 1
    table = rng.permutation(b * mb).reshape(b, mb).astype(np.int32)
    idx = np.asarray([mb * bs, 5, mb * bs - 1], np.int32)
    ku, vu = (rng.randn(l, n_phys, hkv, bs, dh) for _ in range(2))
    q, kn, vn = (rng.randn(b, 1, h, dh) for h in (hq, hkv, hkv))

    def j(a):
        return jnp.asarray(a, jnp.bfloat16)

    ja, jk, jv = _block_cached_attention(
        j(q), j(ku), j(vu), j(kn), j(vn), 1, jnp.asarray(idx),
        jnp.asarray(table))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    tk, tv = t(ku), t(vu)
    before = tk[1, -1].clone()
    ta, _, _ = fused_block_decode_step(t(q), tk, tv, t(kn), t(vn), 1,
                                       torch.from_numpy(idx),
                                       torch.from_numpy(table))
    assert not torch.equal(tk[1, -1], before)    # the garbage row took it
    _assert_pools_equal(tk, jk, dh)
    _assert_pools_equal(tv, jv, dh)
    # the einsum path rounds its logits to bf16 before the softmax; the
    # kernel contract keeps them in f32, hence the wider bound here
    np.testing.assert_allclose(_np(ta), np.asarray(ja, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_supports_block():
    assert supports_block(32, 32, 16, 128)            # LLaMA-7B, bf16 pool
    assert supports_block(32, 32, 16, 128, 1)         # int8/fp8 payload
    assert supports_block(32, 8, 16, 128, 1)          # GQA rep 4
    assert supports_block(4, 2, 16, 16, 1)            # 16-byte 8-bit rows
    assert not supports_block(4, 2, 16, 8, 1)         # 8-byte rows
    assert not supports_block(12, 5, 16, 64)          # hq % hkv
    assert not supports_block(64, 1, 16, 128)         # query group too wide
    assert not supports_block(4, 4, 0, 64)            # no block size
