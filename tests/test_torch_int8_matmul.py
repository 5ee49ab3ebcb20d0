"""Parity of the port's int8 weight-streaming matmul and int8 quantization
(deepspeed_tpu_torch/ops/int8_matmul, compression/quantize, models/base.qdot)
with the JAX package's.

On the CPU the port's ``int8_matmul_dma`` and its gridded form
``int8_matmul`` run their one plain version
(``(x.float() @ q.float()) * s`` cast once); the JAX side runs its Pallas
kernel in interpret mode. Inputs come from one numpy seed.

Tolerances: ``quantize_int8`` must be bit-identical (same f32 scale,
division and round-half-to-even). The matmuls accumulate exact products in
f32 in different orders and cast once to bf16, so they agree to one bf16
ulp: |out - ref| <= 2^-7 * |ref| + 1e-3 (rtol 8e-3). ``qdot``'s einsum-dequant
path rounds the matmul to bf16 and then multiplies the bf16 scale, two
roundings: rtol 1.6e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.compression.quantize import quantize_int8 as jax_quantize_int8
from deepspeed_tpu.models.base import qdot as jax_qdot
from deepspeed_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from deepspeed_tpu.ops.int8_matmul import int8_matmul_dma as jax_int8_matmul_dma
from deepspeed_tpu_torch.compression.quantize import dequantize_int8, quantize_int8
from deepspeed_tpu_torch.models.base import layer_view, qdot
from deepspeed_tpu_torch.ops.int8_matmul import (int8_matmul, int8_matmul_dma,
                                                 k_splits)


def _mk(n, d, e, l=None, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    qshape = (d, e) if l is None else (l, d, e)
    q = rng.randint(-128, 128, qshape).astype(np.int8)
    s = (np.abs(rng.randn(*((e,) if l is None else (l, 1, e)))) * 0.01
         ).astype(np.float32)
    return x, q, s


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _close(out, ref, rtol):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-3)


@pytest.mark.parametrize("n,d,e", [(1, 256, 512), (8, 384, 1408),
                                   (32, 256, 384)])
def test_int8_matmul_dma_matches_jax_kernel(n, d, e):
    x, q, s = _mk(n, d, e)
    ref = jax_int8_matmul_dma(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                              jnp.asarray(s), interpret=True)
    out = int8_matmul_dma(_bf16(x), torch.from_numpy(q), torch.from_numpy(s))
    assert out.dtype == torch.bfloat16 and out.shape == (n, e)
    _close(out, ref, rtol=8e-3)


@pytest.mark.parametrize("layer", [0, 2])
def test_int8_matmul_dma_stacked_layer_matches_jax_kernel(layer):
    x, q, s = _mk(4, 256, 640, l=3, seed=1)
    ref = jax_int8_matmul_dma(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                              jnp.asarray(s), jnp.int32(layer),
                              interpret=True)
    out = int8_matmul_dma(_bf16(x), torch.from_numpy(q), torch.from_numpy(s),
                          layer)
    _close(out, ref, rtol=8e-3)


# the reference test's shapes (tests/unit/ops/test_int8_matmul.py), the
# non-divisible (2, 384, 640) among them; scales carry a leading unit dim
@pytest.mark.parametrize("n,d,e", [(1, 256, 512), (8, 768, 2304),
                                   (2, 1024, 768), (2, 384, 640)])
def test_gridded_int8_matmul_matches_jax_kernel(n, d, e):
    x, q, s = _mk(n, d, e, seed=d)
    s = s.reshape(1, e)
    ref = jax_int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                          jnp.asarray(s), interpret=True)
    out = int8_matmul(_bf16(x), torch.from_numpy(q), torch.from_numpy(s))
    assert out.dtype == torch.bfloat16 and out.shape == (n, e)
    _close(out, ref, rtol=8e-3)


def test_qdot_einsum_path_matches_jax_qdot():
    """> 32 rows (prefill) and every CPU call take the einsum-dequant path
    in both packages; the stacked weight is indexed by layer."""
    x, q, s = _mk(40, 256, 384, l=2, seed=2)
    x3 = x.reshape(2, 20, 256)
    w = {"__q__": q, "__scale__": s}
    jw = jax.tree_util.tree_map(jnp.asarray, w)
    jw["__layer__"] = jnp.int32(1)
    ref = jax_qdot("btd,de->bte", jnp.asarray(x3, jnp.bfloat16), jw)
    tw = layer_view({"w": {k: torch.from_numpy(v) for k, v in w.items()}}, 1)
    out = qdot("btd,de->bte", _bf16(x3), tw["w"])
    _close(out, ref, rtol=1.6e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bit_identical(dtype):
    rng = np.random.RandomState(3)
    w = (rng.randn(3, 64, 96) * 0.02).astype(np.float32)
    w[1, :, 5] = 0.0                       # all-zero column: the 1e-10 floor
    jw = jnp.asarray(w, jnp.dtype(dtype))
    jq, js = jax.vmap(lambda a: jax_quantize_int8(a, per_channel_axis=1))(jw)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    tq, ts = quantize_int8(tw, reduce_dims=(1,))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the per_channel_axis form on one layer agrees with the stacked form
    q1, s1 = quantize_int8(tw[2], per_channel_axis=1)
    assert torch.equal(q1, tq[2]) and torch.equal(s1, ts[2])
    deq = dequantize_int8(tq, ts, torch.float32)
    assert (deq - tw.float()).abs().max() <= ts.max() / 2 + 1e-9


def test_k_splits_depends_on_shape_only():
    # 128 weight rows per block, whatever the batch or the card
    assert k_splits(4096) == 32
    assert k_splits(11008) == 86
    assert k_splits(256) == 2
    assert k_splits(130) == 2
