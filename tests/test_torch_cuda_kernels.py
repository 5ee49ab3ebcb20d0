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
does not depend on its neighbours), and the wrappers' input checks.

Tolerances: caches bit-identical; decode outputs within 2e-2 (bf16),
4e-3 (f16), 1e-5 (f32) absolute on O(1) values — the kernel's online
softmax rounds its probabilities at chunk-local maxima; int8 matmul
outputs within one ulp of the output type (rtol 8e-3 bf16, 1e-3 f16,
1e-5 f32) plus 1e-3 absolute.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops.decode_step import (fused_decode_step,
                                                 fused_decode_step_plain)
from deepspeed_tpu_torch.ops.int8_matmul import (int8_matmul_dma,
                                                 int8_matmul_plain)

pytestmark = pytest.mark.cuda

DECODE_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3, torch.float32: 1e-5}
MATMUL_RTOL = {torch.bfloat16: 8e-3, torch.float16: 1e-3, torch.float32: 1e-5}


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
