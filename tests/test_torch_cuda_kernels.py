"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (in its fixture) where no CUDA device is
present, as on a CPU-only machine. This file imports neither jax nor the
JAX package, so on a card machine without jax it runs with the repo's
conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Coverage beyond chip_smoke.py's full-width checks: every element type the
kernels take, ragged shapes (S not a multiple of the chunk, E not a
multiple of the column tile, odd N), the scalar and per-slot index forms,
the dropped write at idx == S, row independence (a slot's or a row's result
does not depend on its neighbours), and the wrappers' input checks. The
block decode step: bf16/f16/f32 compute over pools in the compute type,
int8 and fp8 (payload and scales), a permuted table, block edges, the
overflow write to the garbage row, an inactive slot on a sentinel table.
The flash attention kernels (forward, backward dQ, backward dK/dV): bf16,
f16 and f32 at Dh 64 and 128, T a multiple of the tile and ragged, causal
and not, Tk != Tq (top-left causal), run-to-run bit identity of the
backward, and the wrappers' input checks. Flash-decode (both computations:
GQA rep >= 2 with p rounded, rep 1 in f32): bf16/f16/f32 at Dh 64, 128 and
256, the CodeLlama-34B decode shape (B 1 and 4, Hq 64 / Hkv 8, S 640), an
odd S, a rep that is not a multiple of the kernel's 8 rows, idx at 0, a
split edge and S - 1, the index as a python int and as a device tensor
(the same bits), values past idx that must not change the output (the
kernel never reads them), run-to-run bit identity, and the wrapper's input
checks.

Tolerances: caches bit-identical (block pools: every row but the garbage
row, which several inactive slots may write at once); flash outputs and
grads, row by row, within 2e-2 (bf16), 4e-3 (f16), 1e-4 (f32) of the row's
own max |ref| (``kernel_check.rel_err``: about two ulps of the row's
largest element; p and dS are rounded at the same points in kernel and
plain version, but the forward's p at tile-local maxima, and sums run in
another order), lse within 1e-4 absolute; decode outputs within
2e-2 (bf16), 4e-3 (f16), 1e-5 (f32) absolute on O(1) values — the kernel's
online softmax rounds its probabilities at chunk-local maxima; int8 matmul
outputs within one ulp of the output type (rtol 8e-3 bf16, 1e-3 f16,
1e-5 f32) plus 1e-3 absolute.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops.decode_step import (fused_block_decode_step,
                                                 fused_block_decode_step_plain,
                                                 fused_decode_step,
                                                 fused_decode_step_plain)
from deepspeed_tpu_torch.ops.flash_decode import (flash_decode,
                                                  flash_decode_mha,
                                                  flash_decode_plain)
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_bwd_dkv,
                                                     flash_bwd_dkv_plain,
                                                     flash_bwd_dq,
                                                     flash_bwd_dq_plain,
                                                     flash_fwd_parts,
                                                     flash_fwd_parts_plain)
from deepspeed_tpu_torch.ops.int8_matmul import (int8_matmul_dma,
                                                 int8_matmul_plain)
from deepspeed_tpu_torch.ops.kernel_check import (block_step_inputs,
                                                  clone_pool, flash_delta,
                                                  flash_inputs,
                                                  real_rows_equal, rel_err)

pytestmark = pytest.mark.cuda

DECODE_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3, torch.float32: 1e-5}
MATMUL_RTOL = {torch.bfloat16: 8e-3, torch.float16: 1e-3, torch.float32: 1e-5}
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _decode_inputs(dev, dtype, b, hq, hkv, s, dh, layers=2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (rnd(b, 1, hq, dh), rnd(layers, b, hkv, s, dh),
            rnd(layers, b, hkv, s, dh), rnd(b, 1, hkv, dh),
            rnd(b, 1, hkv, dh))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("b,hq,hkv,s,dh", [
    (3, 4, 4, 200, 64),      # MHA, S not a multiple of the chunk
    (4, 8, 2, 300, 128),     # GQA rep 4
    (2, 4, 1, 129, 256),     # rep 4 x Dh 256
])
def test_decode_step_matches_plain(cuda, dtype, b, hq, hkv, s, dh):
    q, kf, vf, kn, vn = _decode_inputs(cuda, dtype, b, hq, hkv, s, dh)
    idx = [0, s - 1, s, s // 2][:b]
    for form in (torch.tensor(idx, dtype=torch.int32, device=cuda), idx[1]):
        k1, v1, k2, v2 = kf.clone(), vf.clone(), kf.clone(), vf.clone()
        out, _, _ = fused_decode_step(q, k1, v1, kn, vn, 1, form)
        ref, _, _ = fused_decode_step_plain(q, k2, v2, kn, vn, 1, form)
        torch.cuda.synchronize()
        assert torch.equal(k1, k2) and torch.equal(v1, v2)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= DECODE_TOL[dtype], err


def test_decode_step_rows_are_independent(cuda):
    q, kf, vf, kn, vn = _decode_inputs(cuda, torch.bfloat16, 4, 8, 8, 256, 128)
    idx = torch.tensor([100, 7, 255, 30], dtype=torch.int32, device=cuda)
    out, _, _ = fused_decode_step(q, kf.clone(), vf.clone(), kn, vn, 0, idx)
    kf2, vf2 = kf.clone(), vf.clone()
    kf2[:, 1:] = -kf2[:, 1:]                  # other slots' caches change
    idx2 = idx.clone()
    idx2[1:] = torch.tensor([3, 99, 200], dtype=torch.int32, device=cuda)
    out2, _, _ = fused_decode_step(q, kf2, vf2, kn, vn, 0, idx2)
    assert torch.equal(out[0], out2[0])


def test_decode_step_counts_launches_and_rejects_bad_inputs(cuda):
    q, kf, vf, kn, vn = _decode_inputs(cuda, torch.bfloat16, 2, 4, 4, 64, 64)
    n0 = fused_decode_step.launches
    fused_decode_step(q, kf, vf, kn, vn, 0, 5)
    assert fused_decode_step.launches == n0 + 1
    with pytest.raises(ValueError):     # int64 idx
        fused_decode_step(q, kf, vf, kn, vn, 0,
                          torch.tensor([1, 2], device=cuda))
    with pytest.raises(ValueError):     # non-contiguous cache
        fused_decode_step(q, kf.transpose(3, 4), vf, kn, vn, 0, 5)
    with pytest.raises(ValueError):     # layer out of range
        fused_decode_step(q, kf, vf, kn, vn, 2, 5)
    assert fused_decode_step.launches == n0 + 1


@pytest.mark.parametrize("dtype,kv", [
    (torch.bfloat16, None), (torch.float16, None), (torch.float32, None),
    (torch.bfloat16, "int8"), (torch.bfloat16, "fp8"),
    (torch.float32, "int8"), (torch.float32, "fp8")])
@pytest.mark.parametrize("b,hq,hkv,bs,mb,dh", [
    (5, 4, 4, 16, 8, 128),     # MHA
    (4, 8, 2, 16, 6, 64),      # GQA rep 4, Dh 64
    (3, 4, 1, 32, 4, 128),     # rep 4, wider blocks
])
def test_block_decode_step_matches_plain(cuda, dtype, kv, b, hq, hkv, bs, mb,
                                         dh):
    nblk = (b - 1) * mb + 3
    _, q, kp, vp, kn, vn, table = block_step_inputs(cuda, dtype, kv, b, hq,
                                                    hkv, nblk, bs, mb, dh)
    s = mb * bs
    # position 0, a block edge, the table's last row, a mid position, and
    # the last slot (sentinel table) past the table width: the garbage row
    idx = [0, bs, s - 1, bs + 3][:b - 1] + [s]
    iv = torch.tensor(idx, dtype=torch.int32, device=cuda)
    k1, v1 = clone_pool(kp), clone_pool(vp)
    k2, v2 = clone_pool(kp), clone_pool(vp)
    out, _, _ = fused_block_decode_step(q, k1, v1, kn, vn, 1, iv, table)
    ref, _, _ = fused_block_decode_step_plain(q, k2, v2, kn, vn, 1, iv, table)
    torch.cuda.synchronize()
    assert real_rows_equal(k1, k2) and real_rows_equal(v1, v2)
    assert not real_rows_equal(k1, kp)          # the writes landed
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= DECODE_TOL[dtype], err


def test_block_decode_step_rows_are_independent(cuda):
    _, q, kp, vp, kn, vn, table = block_step_inputs(
        cuda, torch.bfloat16, "int8", 3, 8, 8, 40, 16, 8, 128)
    idx = torch.tensor([100, 7, 30], dtype=torch.int32, device=cuda)
    out, _, _ = fused_block_decode_step(q, clone_pool(kp), clone_pool(vp), kn, vn, 0,
                                        idx, table)
    idx2 = idx.clone()
    idx2[1:] = torch.tensor([3, 120], dtype=torch.int32, device=cuda)
    table2 = table.clone()
    table2[1:] = table2[1:].flip(1)
    out2, _, _ = fused_block_decode_step(q, clone_pool(kp), clone_pool(vp), kn, vn, 0,
                                         idx2, table2)
    assert torch.equal(out[0], out2[0])


def test_block_decode_step_counts_launches_and_rejects_bad_inputs(cuda):
    _, q, kp, vp, kn, vn, table = block_step_inputs(
        cuda, torch.bfloat16, "fp8", 2, 4, 4, 8, 16, 4, 64)
    iv = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    n0 = fused_block_decode_step.launches
    fused_block_decode_step(q, kp, vp, kn, vn, 0, iv, table)
    assert fused_block_decode_step.launches == n0 + 1
    with pytest.raises(ValueError):     # int64 table
        fused_block_decode_step(q, kp, vp, kn, vn, 0, iv, table.long())
    with pytest.raises(ValueError):     # one pool quantized, one not
        fused_block_decode_step(q, kp, vp["q"], kn, vn, 0, iv, table)
    with pytest.raises(ValueError):     # f32 scales
        fused_block_decode_step(q, {"q": kp["q"], "s": kp["s"].float()}, vp,
                                kn, vn, 0, iv, table)
    with pytest.raises(ValueError):     # layer out of range
        fused_block_decode_step(q, kp, vp, kn, vn, 2, iv, table)
    assert fused_block_decode_step.launches == n0 + 1


def _mm_inputs(dev, dtype, n, d, e, layers=2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-128, 128, (layers, d, e), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((layers, 1, e), generator=g, device=dev) * 0.02
    x = torch.randn((n, d), generator=g, device=dev).to(dtype)
    return x, q, s


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("n,d,e", [(1, 512, 1408), (3, 640, 256),
                                   (8, 4096, 4096), (17, 384, 2048),
                                   (32, 1024, 11008)])
def test_int8_matmul_matches_plain(cuda, dtype, n, d, e):
    x, q, s = _mm_inputs(cuda, dtype, n, d, e)
    out = int8_matmul_dma(x, q, s, 1)
    ref = int8_matmul_plain(x, q, s, 1)
    err = (out.float() - ref.float()).abs()
    assert (err <= MATMUL_RTOL[dtype] * ref.float().abs() + 1e-3).all(), \
        err.max().item()
    # the unstacked form on the same layer
    out2 = int8_matmul_dma(x, q[1].contiguous(), s[1].reshape(-1).contiguous())
    assert torch.equal(out, out2)


def test_int8_matmul_row_result_independent_of_batch(cuda):
    x, q, s = _mm_inputs(cuda, torch.bfloat16, 32, 1024, 2048)
    full = int8_matmul_dma(x, q, s, 0)
    for n in (1, 2, 5, 8, 16):
        assert torch.equal(int8_matmul_dma(x[:n].contiguous(), q, s, 0),
                           full[:n])


def test_int8_matmul_rejects_bad_inputs(cuda):
    x, q, s = _mm_inputs(cuda, torch.bfloat16, 33, 256, 512)
    n0 = int8_matmul_dma.launches
    with pytest.raises(ValueError):     # > 32 rows
        int8_matmul_dma(x, q, s, 0)
    with pytest.raises(ValueError):     # stacked without a layer
        int8_matmul_dma(x[:4].contiguous(), q, s)
    with pytest.raises(TypeError):      # bf16 scales
        int8_matmul_dma(x[:4].contiguous(), q, s.to(torch.bfloat16), 0)
    assert int8_matmul_dma.launches == n0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("tq,tk", [(128, 128), (48, 48), (200, 200),
                                   (96, 160), (160, 96)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_match_plain(cuda, dtype, dh, tq, tk, causal):
    q, k, v, do = flash_inputs(cuda, dtype, 6, tq, dh, tk=tk, seed=tq + dh)
    out, lse = flash_fwd_parts(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd_parts_plain(q, k, v, causal=causal)
    assert rel_err(out, ref) <= FLASH_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    delta = flash_delta(do, ref)
    dq = flash_bwd_dq(q, k, v, do, ref_lse, delta, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal=causal)
    rdq = flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal=causal)
    rdk, rdv = flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, causal=causal)
    torch.cuda.synchronize()
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(got.float()).all()
        assert rel_err(got, want) <= FLASH_TOL[dtype]


def test_flash_backward_is_bit_identical_run_to_run(cuda):
    q, k, v, do = flash_inputs(cuda, torch.bfloat16, 8, 300, 64)
    out, lse = flash_fwd_parts(q, k, v, causal=True)
    delta = flash_delta(do, out)
    first = (flash_bwd_dq(q, k, v, do, lse, delta, causal=True),
             *flash_bwd_dkv(q, k, v, do, lse, delta, causal=True))
    again = (flash_bwd_dq(q, k, v, do, lse, delta, causal=True),
             *flash_bwd_dkv(q, k, v, do, lse, delta, causal=True))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_attention_autograd_runs_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 130, 4, 64), generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    n = (flash_fwd_parts.launches, flash_bwd_dq.launches,
         flash_bwd_dkv.launches)
    out = flash_attention(q, k, v, True)
    out.float().square().sum().backward()
    assert (flash_fwd_parts.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    for t in (q, k, v):
        assert t.grad.shape == t.shape and torch.isfinite(t.grad.float()).all()


def test_flash_wrappers_reject_bad_inputs(cuda, monkeypatch):
    q, k, v, do = flash_inputs(cuda, torch.bfloat16, 2, 64, 64)
    n0 = flash_fwd_parts.launches
    with pytest.raises(ValueError):     # Dh 96
        flash_fwd_parts(*flash_inputs(cuda, torch.bfloat16, 2, 64, 96)[:3],
                        causal=True)
    with pytest.raises(ValueError):     # float64
        flash_fwd_parts(q.double(), k.double(), v.double(), causal=True)
    with pytest.raises(ValueError):     # non-contiguous
        flash_fwd_parts(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                        v, causal=True)
    with pytest.raises(ValueError):     # mixed dtypes
        flash_fwd_parts(q, k.half(), v, causal=True)
    monkeypatch.setenv("DSTPU_FLASH_F32_PRECISE", "1")
    with pytest.raises(ValueError):     # f32 p/dS operands not in the kernel
        flash_fwd_parts(q, k, v, causal=True)
    assert flash_fwd_parts.launches == n0


# flash-decode outputs, row by row (kernel_check.rel_err): the kernel rounds
# p at warp-local running maxima, the plain version at the row maximum
FLASH_DECODE_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3,
                    torch.float32: 1e-5}


def _flash_decode_inputs(dev, dtype, b, hq, hkv, s, dh, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return rnd(b, 1, hq, dh), rnd(b, hkv, s, dh), rnd(b, hkv, s, dh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("b,hq,hkv,s,dh", [
    (1, 64, 8, 640, 128),    # CodeLlama-34B decode, batch 1
    (4, 64, 8, 640, 128),    # ... batch 4
    (2, 12, 1, 300, 64),     # rep 12 (two row groups), odd S
    (2, 8, 2, 129, 256),     # Dh 256
    (3, 4, 4, 200, 128),     # rep 1: the f32 variant
])
def test_flash_decode_matches_plain(cuda, dtype, b, hq, hkv, s, dh):
    q, k, v = _flash_decode_inputs(cuda, dtype, b, hq, hkv, s, dh)
    for idx in (0, 31, 32, 127, s // 2, s - 1):
        for form in (idx, torch.tensor(idx, dtype=torch.int32, device=cuda)):
            out = flash_decode(q, k, v, form)
            ref = flash_decode_plain(q, k, v, idx)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all()
            err = rel_err(out, ref)
            assert err <= FLASH_DECODE_TOL[dtype], (idx, err)


def test_flash_decode_ignores_values_past_idx_and_repeats_bits(cuda):
    for hq, hkv in ((64, 8), (8, 8)):
        q, k, v = _flash_decode_inputs(cuda, torch.bfloat16, 2, hq, hkv, 640,
                                       128, seed=1)
        for idx in (0, 127, 128, 500):
            out = flash_decode(q, k, v, idx)
            k2, v2 = k.clone(), v.clone()
            k2[:, :, idx + 1:] = 1e4
            v2[:, :, idx + 1:] = 1e4
            assert torch.equal(flash_decode(q, k2, v2, idx), out)
            assert torch.equal(flash_decode(q, k, v, idx), out)
            dev_idx = torch.tensor(idx, dtype=torch.int32, device=cuda)
            assert torch.equal(flash_decode(q, k, v, dev_idx), out)


def test_flash_decode_counts_launches_and_rejects_bad_inputs(cuda):
    q, k, v = _flash_decode_inputs(cuda, torch.bfloat16, 1, 16, 2, 256, 128)
    n0, m0 = flash_decode.launches, flash_decode_mha.launches
    flash_decode(q, k, v, 7)
    assert flash_decode.launches == n0 + 1
    flash_decode(q[:, :, :2], k, v, 7)                # rep 1: the f32 variant
    assert (flash_decode.launches, flash_decode_mha.launches) == (n0 + 1,
                                                                  m0 + 1)
    with pytest.raises(ValueError):     # Dh 96
        flash_decode(*_flash_decode_inputs(cuda, torch.bfloat16, 1, 16, 2,
                                           64, 96), 3)
    with pytest.raises(ValueError):     # int64 index tensor
        flash_decode(q, k, v, torch.tensor(3, device=cuda))
    with pytest.raises(ValueError):     # non-contiguous cache
        flash_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, 3)
    with pytest.raises(ValueError):     # mixed dtypes
        flash_decode(q, k.half(), v, 3)
    with pytest.raises(ValueError):     # the rep-1 wrapper at rep 8
        flash_decode_mha(q, k, v, 3)
    assert (flash_decode.launches, flash_decode_mha.launches) == (n0 + 1,
                                                                  m0 + 1)
