"""Parity of the port's fused decode step (deepspeed_tpu_torch/ops/decode_step)
with the JAX package's.

On the CPU the port's ``fused_decode_step`` runs its plain version; the JAX
side runs its Pallas kernel in interpret mode (as tests/unit/ops runs it).
Inputs are made once with numpy and handed to both. The JAX cache is the
token-pair packed view for Dh < 128, a free row-major reshape of the
logical ``[L, B, Hkv, S, Dh]`` layout the port keeps.

Tolerance: the written caches must be bit-identical. Attention outputs are
bf16 and agree within atol 1e-2 + rtol 1e-2: both sum bf16 products in f32
and round the probabilities to bf16 before P.V, but in different orders, so
the single final bf16 rounding may land one ulp apart (bf16 ulp at |x| ~ 1
is 2^-7 ~ 0.008).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import cached_attention as jax_cached_attention
from deepspeed_tpu.ops.attention import kv_pack_factor
from deepspeed_tpu.ops.decode_step import fused_decode_step as jax_fused_decode_step
from deepspeed_tpu_torch.ops.decode_step import (block_split_plan,
                                                 fused_decode_step,
                                                 split_plan, supports)

ATOL, RTOL = 1e-2, 1e-2


def _inputs(b, l, hq, hkv, s, dh, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, hq, dh).astype(np.float32)
    kf = rng.randn(l, b, hkv, s, dh).astype(np.float32)
    vf = rng.randn(l, b, hkv, s, dh).astype(np.float32)
    kn = rng.randn(b, 1, hkv, dh).astype(np.float32)
    vn = rng.randn(b, 1, hkv, dh).astype(np.float32)
    return q, kf, vf, kn, vn


def _to_torch(*arrs):
    # bf16 rounding done by torch (round-to-nearest-even, like jnp.astype)
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]


@pytest.mark.parametrize("b,l,hq,hkv,s,dh,idx", [
    (2, 3, 4, 4, 256, 64, 100),                 # MHA, Dh 64, scalar idx
    (2, 2, 8, 2, 256, 128, 200),                # GQA rep 4, Dh 128, scalar
    (1, 2, 4, 4, 256, 128, 0),                  # first decode position
    (4, 2, 4, 4, 256, 64, [100, 3, 255, 0]),    # MHA per-slot, Dh 64
    (2, 2, 8, 2, 256, 128, [200, 17]),          # GQA per-slot, Dh 128
    (4, 3, 4, 2, 512, 64, [511, 130, 0, 258]),  # per-slot across chunks
])
def test_fused_decode_step_matches_jax_kernel(b, l, hq, hkv, s, dh, idx):
    q, kf, vf, kn, vn = _inputs(b, l, hq, hkv, s, dh)
    layer = l - 1
    pair = kv_pack_factor(dh)
    packed = (l, b, hkv, s // pair, dh * pair)
    jidx = jnp.asarray(idx, jnp.int32)
    ja, jk, jv = jax_fused_decode_step(
        jnp.asarray(q, jnp.bfloat16),
        jnp.asarray(kf, jnp.bfloat16).reshape(packed),
        jnp.asarray(vf, jnp.bfloat16).reshape(packed),
        jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
        jnp.int32(layer), jidx, interpret=True)

    tq, tk, tv, tkn, tvn = _to_torch(q, kf, vf, kn, vn)
    tidx = (torch.tensor(idx, dtype=torch.int32) if isinstance(idx, list)
            else idx)
    ta, tk2, tv2 = fused_decode_step(tq, tk, tv, tkn, tvn, layer, tidx)
    assert tk2 is tk and tv2 is tv   # written in place

    np.testing.assert_array_equal(
        tk.float().numpy(), np.asarray(jk.reshape(kf.shape), np.float32))
    np.testing.assert_array_equal(
        tv.float().numpy(), np.asarray(jv.reshape(vf.shape), np.float32))
    np.testing.assert_allclose(ta.float().numpy(), np.asarray(ja, np.float32),
                               atol=ATOL, rtol=RTOL)


def test_drop_write_past_allocation_matches_jax_einsum_path():
    """idx == S (an inactive slot's stale length at a full cache): the write
    is dropped and the slot attends over all S positions. The TPU kernel has
    no bounds guard for this case, so the reference is the JAX einsum path
    (cached_attention on the CPU: write_kv_cache(mode="drop"))."""
    b, l, hq, hkv, s, dh = 3, 2, 8, 2, 128, 128
    q, kf, vf, kn, vn = _inputs(b, l, hq, hkv, s, dh, seed=3)
    idx = [s, 5, s - 1]
    layer = 1
    ja, jk, jv = jax_cached_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kf, jnp.bfloat16),
        jnp.asarray(vf, jnp.bfloat16), jnp.asarray(kn, jnp.bfloat16),
        jnp.asarray(vn, jnp.bfloat16), jnp.int32(layer),
        jnp.asarray(idx, jnp.int32))
    tq, tk, tv, tkn, tvn = _to_torch(q, kf, vf, kn, vn)
    before = tk.clone()
    ta, _, _ = fused_decode_step(tq, tk, tv, tkn, tvn, layer,
                                 torch.tensor(idx, dtype=torch.int32))
    assert torch.equal(tk[layer, 0], before[layer, 0])   # slot 0: dropped
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))
    # the einsum path rounds its logits to bf16 before the softmax; the
    # kernel contract keeps them in f32, hence the wider bound here
    np.testing.assert_allclose(ta.float().numpy(), np.asarray(ja, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_supports():
    assert supports(32, 32, 1024, 128)          # LLaMA-7B
    assert supports(32, 8, 1024, 128)           # GQA rep 4
    assert supports(4, 2, 128, 16)              # bf16 rows of 32 bytes
    assert not supports(4, 2, 128, 4)           # 8-byte rows: no 16B loads
    assert not supports(12, 5, 640, 64)         # hq % hkv
    assert not supports(64, 1, 640, 128)        # query group too wide


@pytest.mark.parametrize("b,hkv,s,sms,want", [
    (8, 32, 1024, 132, (1024, 1)),   # LLaMA-7B MHA, 8 slots
    (8, 8, 1024, 132, (512, 2)),     # LLaMA-7B at rep 4
    (4, 8, 640, 132, (256, 3)),      # CodeLlama-34B, batch 4
    (4, 20, 256, 132, (256, 1)),     # GPT-2 774M, batch 4
    (1, 1, 50, 132, (64, 1)),        # a prefix shorter than one stage
    (64, 32, 4096, 132, (4096, 1)),  # enough (slot, head) pairs alone
])
def test_split_plan_at_known_shapes(b, hkv, s, sms, want):
    assert split_plan(b, hkv, s, sms) == want


@pytest.mark.parametrize("b", [1, 3, 8, 32])
@pytest.mark.parametrize("hkv", [1, 8, 32])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 640, 1024, 3000])
def test_split_plan_covers_s_and_fills_the_card(b, hkv, s):
    """The splits cover positions 0..S-1 exactly once, the chunk is a
    power-of-two multiple of the tensor-core body's 64-position stage, the
    grid at full S holds at most one block per SM unless the chunk covers
    S, and a chunk above 64 is the smallest that does: half of it would
    have put more than one block on an SM."""
    sms = 132
    chunk, n = split_plan(b, hkv, s, sms)
    assert chunk % 64 == 0 and (chunk // 64) & (chunk // 64 - 1) == 0
    assert (n - 1) * chunk < s <= n * chunk
    assert b * hkv * n <= sms or chunk >= s
    if chunk > 64:
        assert b * hkv * -(-s // (chunk // 2)) > sms


@pytest.mark.parametrize("b,hkv,s,dh,itemsize,want", [
    (1, 8, 640, 128, 4, (32, 20)),   # f32 CodeLlama-34B shape, batch 1
    (4, 8, 640, 128, 4, (128, 5)),   # ... batch 4
    (1, 8, 640, 64, 4, (64, 10)),    # f32 at Dh 64: 64-position batches
    (1, 8, 640, 256, 4, (32, 20)),   # f32 at Dh 256: 16-position batches, x 2
    (6, 2, 300, 40, 2, (64, 5)),     # bf16 at Dh 40: no tensor-core width
    (8, 32, 1024, 128, 2, (1024, 1)),  # bf16 at Dh 128: the tensor cores
])
def test_split_plan_on_the_cuda_core_body(b, hkv, s, dh, itemsize, want):
    """f32, and a head width the tensor-core body has no form for, run the
    CUDA-core body: its smallest chunk is one copy batch (16 KB of K rows,
    8 to 64 positions), doubling while the grid at full S holds more than
    two blocks per SM."""
    chunk, n = split_plan(b, hkv, s, 132, dh, itemsize)
    assert (chunk, n) == want
    if itemsize == 4 or dh not in (64, 128, 256):
        assert b * hkv * n <= 2 * 132 or chunk >= s


@pytest.mark.parametrize("b,hkv,s,sms,want", [
    (8, 32, 1024, 132, (256, 4)),    # LLaMA-7B MHA, 8 slots
    (8, 8, 1024, 132, (64, 16)),     # LLaMA-7B at rep 4
    (8, 32, 512, 132, (128, 4)),     # the block card tests' pool (MB 32 x 16)
    (1, 1, 50, 132, (64, 1)),        # a prefix shorter than one stage
    (64, 32, 4096, 132, (4096, 1)),  # enough (slot, head) pairs alone
])
def test_block_split_plan_at_known_shapes(b, hkv, s, sms, want):
    assert block_split_plan(b, hkv, s, sms) == want


@pytest.mark.parametrize("b", [1, 3, 8, 32])
@pytest.mark.parametrize("hkv", [1, 8, 32])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 640, 1024, 3000])
def test_block_split_plan_covers_s_and_keeps_four_blocks_an_sm(b, hkv, s):
    """Kernel C's plan: the splits cover positions 0..S-1 exactly once, the
    chunk is a power-of-two multiple of the 64-position stage, and a chunk
    above 64 leaves the grid at full S at least four blocks per SM."""
    sms = 132
    chunk, n = block_split_plan(b, hkv, s, sms)
    assert chunk % 64 == 0 and (chunk // 64) & (chunk // 64 - 1) == 0
    assert (n - 1) * chunk < s <= n * chunk
    if chunk > 64:
        assert b * hkv * -(-s // chunk) >= 4 * sms
