"""Parity of the port's flash-decode (deepspeed_tpu_torch/ops/flash_decode.py)
with the JAX package's, and of its routing (ops/attention.decode_route) with
the reference's two gates.

``flash_decode_plain`` (what the port runs on a CPU tensor, and what the
CUDA kernel is held to on the card) against JAX ``flash_decode`` in
interpret mode, at the reference test's cases (S 64, Dh 16, block_s 16:
tests/unit/ops/test_flash_decode.py) plus GQA rep 8 (Hq 8/Hkv 1, Hq
16/Hkv 2), the rep-1 variant (the reference's ``_mha_kernel``), index 0
and S - 1, and garbage past the index.

Tolerances: f32 within rtol/atol 2e-4, as the reference test holds its
kernel to the einsum (the same f32 math; the kernel's online softmax
rescales at block-local maxima). bf16 within one bf16 ulp of each output
row's largest element: both round each probability to bf16 before P.V,
but the reference at its running block maximum and the plain version at
the row maximum, so a probability may round the other way (2^-9
relative), and the output's own rounding to bf16 may then land one ulp
apart. Garbage past the index leaves the plain version's output bit for
bit unchanged (masked scores are -inf, so their probabilities are exact
zeros).

The route is held against the reference's own code: JAX
``cached_attention`` is called with ``jax.default_backend`` reading
"tpu" and its two kernels replaced by spies, over a grid of batch, GQA
rep, S, Dh, dtype and index kind; where the reference runs its einsum the
port runs the fused step (ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.attention as jattn
import deepspeed_tpu.ops.decode_step as jdecode
import deepspeed_tpu.ops.flash_decode as jflash
from deepspeed_tpu.ops.flash_decode import flash_decode as jax_flash_decode
import deepspeed_tpu_torch.ops.flash_decode as tflash
from deepspeed_tpu_torch.ops import cuda_build
from deepspeed_tpu_torch.ops.attention import decode_route
from deepspeed_tpu_torch.ops.decode_step import split_plan
from deepspeed_tpu_torch.ops.flash_decode import (flash_decode,
                                                  flash_decode_mha,
                                                  flash_decode_plain,
                                                  plan)

S_MAX, DH = 64, 16
CASES = [(1, 4, 4, 17), (8, 4, 4, 63), (2, 8, 2, 30), (2, 16, 2, 45),
         (1, 8, 1, 33), (2, 16, 2, 0), (3, 8, 1, S_MAX - 1)]


def _inputs(b, hq, hkv, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, 1, hq, DH) * 0.5).astype(np.float32)
    k = rng.randn(b, hkv, S_MAX, DH).astype(np.float32)
    v = rng.randn(b, hkv, S_MAX, DH).astype(np.float32)
    return q, k, v


def _jax(q, k, v, idx, dtype):
    jdt = jnp.dtype(dtype)
    out = jax_flash_decode(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                           jnp.asarray(v, jdt), jnp.int32(idx), block_s=16)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, idx, dtype):
    tdt = getattr(torch, dtype)
    out = flash_decode(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), idx)
    assert out.dtype == tdt and out.shape == q.shape
    return out.float().numpy()


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-30))) - 7)


@pytest.mark.parametrize("b,hq,hkv,idx", CASES)
def test_plain_matches_jax_kernel_f32(b, hq, hkv, idx):
    q, k, v = _inputs(b, hq, hkv)
    np.testing.assert_allclose(_port(q, k, v, idx, "float32"),
                               _jax(q, k, v, idx, "float32"),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,hq,hkv,idx", CASES)
def test_plain_matches_jax_kernel_bf16_within_an_ulp_of_the_row(b, hq, hkv,
                                                                idx):
    q, k, v = _inputs(b, hq, hkv, seed=1)
    ref = _jax(q, k, v, idx, "bfloat16")
    out = _port(q, k, v, idx, "bfloat16")
    row_max = np.abs(ref).max(-1, keepdims=True)
    assert (np.abs(out - ref) <= _bf16_ulp(row_max)).all(), \
        np.abs(out - ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_garbage_past_the_index_is_masked(dtype):
    b, hq, hkv, idx = 2, 16, 2, 9
    q, k, v = _inputs(b, hq, hkv, seed=2)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, idx + 1:] = 1e4
    v2[:, :, idx + 1:] = -1e4
    np.testing.assert_array_equal(_port(q, k, v, idx, dtype),
                                  _port(q, k2, v2, idx, dtype))
    np.testing.assert_allclose(_port(q, k2, v2, idx, "float32"),
                               _jax(q, k2, v2, idx, "float32"),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("idx", [0, S_MAX - 1])
def test_index_edges_and_tensor_index(idx):
    q, k, v = _inputs(2, 16, 2, seed=3)
    ref = _jax(q, k, v, idx, "float32")
    np.testing.assert_allclose(_port(q, k, v, idx, "float32"), ref,
                               rtol=2e-4, atol=2e-4)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    by_tensor = flash_decode(tq, tk, tv, torch.tensor(idx, dtype=torch.int32))
    assert torch.equal(by_tensor, flash_decode(tq, tk, tv, idx))
    if idx == 0:    # one valid position: the output is v[0] of each kv head
        want = np.repeat(v[:, :, 0], 8, axis=1)[:, None]
        np.testing.assert_allclose(_port(q, k, v, idx, "float32"), want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,idx", [(1, 4, 17), (8, 4, 63), (3, 2, 0)])
def test_rep1_variant_matches_jax_mha_kernel(dtype, b, h, idx):
    """The reference's ``_mha_kernel`` (all f32, p not rounded) against
    :func:`flash_decode_mha`, which :func:`flash_decode` dispatches rep 1
    to; bf16 within an ulp of the row for the output's own rounding."""
    q, k, v = _inputs(b, h, h, seed=4)
    ref = _jax(q, k, v, idx, dtype)
    out = _port(q, k, v, idx, dtype)
    tdt = getattr(torch, dtype)
    direct = flash_decode_mha(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), idx)
    np.testing.assert_array_equal(direct.float().numpy(), out)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    else:
        row_max = np.abs(ref).max(-1, keepdims=True)
        assert (np.abs(out - ref) <= _bf16_ulp(row_max)).all()


def test_rounding_differs_between_the_two_computations():
    """The GQA computation rounds p to bf16 before P.V, the rep-1 one does
    not: one kv head's output computed both ways differs, as the
    reference's two kernels do."""
    q, k, v = _inputs(1, 8, 1, seed=5)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    gqa = flash_decode_plain(tq, tk, tv, 40).float()
    mha = torch.cat([flash_decode_plain(tq[:, :, r:r + 1], tk, tv, 40)
                     for r in range(8)], dim=2).float()
    assert not torch.equal(gqa, mha)
    assert (gqa - mha).abs().max() < 0.05


def test_plan_splits_along_s():
    """The rep-1 kernel's plan: the whole prefix in one block per head while
    the heads fill the SMs, else halving chunks of whole 32-position
    stages, no shorter than 64."""
    sms = 132
    assert plan(8, 32, 1024, sms) == (1024, 1)     # LLaMA-7B MHA, 256 blocks
    assert plan(1, 32, 1024, sms) == (128, 8)      # batch 1: 256 blocks
    assert plan(4, 8, 640, sms) == (96, 7)         # 224 blocks
    assert plan(1, 8, 640, sms) == (64, 10)        # the floor: 80 blocks
    assert plan(1, 1, 100, sms) == (64, 2)
    chunk, n = plan(2, 2, 4096, sms)
    assert chunk * n >= 4096 and chunk * (n - 1) < 4096


@pytest.mark.parametrize("b,h,s,sms", [
    (8, 32, 1024, 132), (1, 32, 1024, 132), (4, 8, 640, 132), (1, 1, 100, 132),
    (2, 2, 300, 80), (3, 4, 200, 132), (8, 32, 1000, 114), (64, 32, 64, 132),
    (1, 20, 4096, 132)])
def test_rep1_plan_from_the_shapes_alone(b, h, s, sms):
    """(chunk, n_splits) of the rep-1 kernel from (B, H, S, SMs) alone (the
    same at every Dh): chunks of whole 32-position stages covering S once;
    one split while the heads alone give every SM a block, else the longest
    chunk (>= 64) that does, or 64."""
    chunk, n = plan(b, h, s, sms)
    assert plan(b, h, s, sms) == (chunk, n)
    assert chunk % 32 == 0 and chunk >= min(64, -(-s // 32) * 32)
    assert chunk * n >= s and chunk * (n - 1) < s
    if b * h >= sms:
        assert n == 1
    else:
        assert b * h * n >= sms or chunk == 64
        assert chunk >= s or b * h * -(-s // (2 * chunk)) < sms


@pytest.mark.parametrize("b,hkv,s,sms", [
    (1, 8, 640, 132), (4, 8, 640, 132), (1, 8, 896, 132), (1, 1, 100, 132),
    (8, 8, 4096, 132), (2, 2, 300, 80), (1, 8, 640, 114), (32, 8, 64, 132)])
def test_gqa_plan_from_the_shapes_alone(b, hkv, s, sms):
    """The rep >= 2 kernel's split plan is kernel B's (``split_plan``), so
    the two give the same bits on one cache: (chunk, n_splits) from (B,
    Hkv, S, SMs, Dh, element size) alone, the splits covering S once. On
    the tensor-core body (16-bit) the chunk is a multiple of the 64-position
    stage with at most one block per SM at full S unless the chunk covers
    S; on the CUDA-core body (f32) a multiple of its 32-position copy batch
    at Dh 128 with at most two blocks per SM."""
    for itemsize, stage, per_sm in ((2, 64, 1), (4, 32, 2)):
        chunk, n = split_plan(b, hkv, s, sms, 128, itemsize)
        assert chunk % stage == 0 and chunk * n >= s and chunk * (n - 1) < s
        assert b * hkv * n <= per_sm * sms or chunk >= s
        assert chunk == stage or b * hkv * -(-s // (chunk // 2)) > per_sm * sms
    if (b, hkv, s, sms) == (1, 8, 640, 132):      # CodeLlama-34B, batch 1
        assert split_plan(b, hkv, s, sms, 128, 2) == (64, 10)
        assert split_plan(b, hkv, s, sms, 128, 4) == (32, 20)
    if (b, hkv, s, sms) == (4, 8, 640, 132):      # ... batch 4: 96 blocks
        assert split_plan(b, hkv, s, sms, 128, 2) == (256, 3)
        assert split_plan(b, hkv, s, sms, 128, 4) == (128, 5)


class _FakeLib:
    """Stands in for the kernel library: records dst_flash_decode's
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def dst_flash_decode(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("b,hq,hkv,s,dh", [
    (1, 64, 8, 640, 128), (4, 64, 8, 640, 128), (2, 8, 8, 300, 64),
    (1, 32, 2, 1000, 256)])
def test_wrapper_launches_with_its_plan(monkeypatch, b, hq, hkv, s, dh):
    """The CUDA path's arguments, traced on meta tensors with the library
    replaced: rep >= 2 launches under kernel B's ``split_plan``, rep 1 under
    :func:`plan`, with split scratch for every split, from the shapes and
    the card's SM count alone (idx goes through as it came)."""
    lib = _FakeLib()
    monkeypatch.setattr(cuda_build, "kernels", lambda: lib)
    monkeypatch.setattr(cuda_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    q = torch.empty((b, 1, hq, dh), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, hkv, s, dh), dtype=torch.bfloat16, device="meta")
    out = tflash._launch(q, k, k, s - 1, None, hq == hkv, "flash_decode")
    assert out.shape == q.shape and out.device.type == "meta"
    (args,) = lib.calls
    chunk, n_splits, mha = args[13], args[14], args[17]
    want = (plan(b, hkv, s, 132) if hq == hkv
            else split_plan(b, hkv, s, 132, dh, 2))
    assert (chunk, n_splits) == want and mha == int(hq == hkv)
    assert args[7] == s - 1 and args[8:13] == (b, hq, hkv, s, dh)
    assert (args[4] is None) == (args[5] is None) == (n_splits == 1)


# ------------------------------------------------------------------ routing
def _reference_route(monkeypatch, b, rep, s, dh, dtype, per_slot):
    """What JAX ``cached_attention`` runs for one decode step on a TPU
    backend: its kernels are spies, so nothing but the gates executes."""
    calls = []
    hkv, layers = 8, 1
    hq = hkv * rep
    jdt = jnp.dtype(dtype)

    def fused(q, *a, **kw):
        calls.append("fused")
        return jnp.zeros(q.shape, q.dtype), a[0], a[1]

    def flash(q, *a, **kw):
        calls.append("flash_decode")
        return jnp.zeros(q.shape, q.dtype)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jdecode, "fused_decode_step", fused)
    monkeypatch.setattr(jflash, "flash_decode", flash)
    kc = jattn.alloc_kv_cache(layers, b, hkv, s, dh, jdt)
    q = jnp.zeros((b, 1, hq, dh), jdt)
    kn = jnp.zeros((b, 1, hkv, dh), jdt)
    idx = jnp.full((b,), 5, jnp.int32) if per_slot else jnp.int32(5)
    jattn.cached_attention(q, kc, kc, kn, kn, 0, idx)
    return calls[0] if calls else "einsum"


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("b", [1, 2])
def test_decode_route_follows_the_reference_gates(monkeypatch, b, dh, dtype,
                                                  per_slot):
    itemsize = jnp.dtype(dtype).itemsize
    for rep in (1, 4, 8):
        for s in (200, 640, 1024, 2048):
            ref = _reference_route(monkeypatch, b, rep, s, dh, dtype, per_slot)
            want = "fused" if ref == "einsum" else ref
            got = decode_route(b, 1, 8 * rep, 8, s, dh, itemsize,
                               not per_slot)
            assert got == want, (b, rep, s, dh, dtype, per_slot, ref, got)
    assert decode_route(b, 4, 64, 8, 640, dh, itemsize, True) == "prefill"


def test_decode_route_at_the_slice_shapes():
    """CodeLlama-34B widths (Hq 64 / Hkv 8, Dh 128, bf16): batch 1 takes
    flash-decode up to S = 896 (a 1.75 MiB K cache per layer), the fused
    step from S = 1024 (2 MiB) and at batch 4; GPT-2 774M (20 heads of
    Dh 64) at batch 4 takes the fused step."""
    assert decode_route(1, 1, 64, 8, 640, 128, 2, True) == "flash_decode"
    assert decode_route(1, 1, 64, 8, 896, 128, 2, True) == "flash_decode"
    assert decode_route(1, 1, 64, 8, 1024, 128, 2, True) == "fused"
    assert decode_route(4, 1, 64, 8, 640, 128, 2, True) == "fused"
    assert decode_route(4, 1, 20, 20, 256, 64, 2, True) == "fused"
