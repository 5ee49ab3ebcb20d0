"""Parity of the port's flash attention (deepspeed_tpu_torch/ops/flash_attention.py,
its plain versions on the CPU) with the JAX package's Pallas kernels, run in
interpret mode as the JAX package's own tests run them.

Inputs come from numpy with a seed and go to both packages. Cases:

* the reference's own cases (tests/unit/ops/test_flash_attention.py): f32,
  T in {32, 48, 64, 96}, causal and not, a custom scale; forward within
  rtol/atol 2e-5 and gradients within 2e-4 (the same f32 math, with the
  JAX side's online softmax over 32 x 16 tiles against the port's one
  pass: only the summation order differs); bf16 within 5e-2 (p is rounded
  to bf16 before P.V at tile-local maxima on the JAX side, at the row
  maximum in the plain version: one bf16 ulp, 2^-8, of O(1) values);
* ``flash_fwd_parts``' lse (f32, 1e-5) and ``flash_bwd_parts`` with
  Tk != Tq, where causal masking is top-left aligned, from the same global
  lse and delta (2e-4);
* the port's flash against its own dense ``multihead_attention``, forward
  and gradients (f32, 2e-5 / 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.flash_attention as jflash
from deepspeed_tpu_torch.ops.attention import multihead_attention
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_bwd_parts,
                                                     flash_fwd_parts)


def _qkv(b=2, t=64, h=2, dh=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, dh).astype(np.float32) * 0.5 for _ in range(3)]


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _torch(x, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype).requires_grad_(grad)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_flash(q, k, v, causal, scale=None):
    return jflash.flash_attention(q, k, v, causal, scale, 32, 16, True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [32, 48, 64, 96])
def test_forward_matches_jax_f32(causal, t):
    q, k, v = _qkv(t=t, seed=t)
    ref = _jax_flash(_jax(q), _jax(k), _jax(v), causal)
    out = flash_attention(_torch(q), _torch(k), _torch(v), causal)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [48, 64])
def test_gradients_match_jax_f32(causal, t):
    q, k, v = _qkv(t=t, seed=100 + t)

    def jloss(q, k, v):
        return jnp.sum(_jax_flash(q, k, v, causal) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_jax(q), _jax(k), _jax(v))
    tq, tk, tv = (_torch(x, grad=True) for x in (q, k, v))
    flash_attention(tq, tk, tv, causal).square().sum().backward()
    for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")


def test_custom_scale_matches_jax():
    q, k, v = _qkv(seed=2)
    ref = _jax_flash(_jax(q), _jax(k), _jax(v), True, 0.1)
    out = flash_attention(_torch(q), _torch(k), _torch(v), True, 0.1)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)


def test_bf16_matches_jax():
    q, k, v = _qkv(seed=3)
    ref = _jax_flash(_jax(q, jnp.bfloat16), _jax(k, jnp.bfloat16),
                     _jax(v, jnp.bfloat16), True)
    out = flash_attention(_torch(q, torch.bfloat16), _torch(k, torch.bfloat16),
                          _torch(v, torch.bfloat16), True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), rtol=5e-2, atol=5e-2)


def _flat(x):
    b, t, h, dh = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, dh))


def test_fwd_parts_lse_matches_jax():
    q, k, v = (_flat(x) for x in _qkv(t=96, seed=5))
    jo, jl = jflash.flash_fwd_parts(_jax(q), _jax(k), _jax(v), causal=True,
                                    block_q=32, block_k=16, interpret=True)
    to, tl = flash_fwd_parts(_torch(q), _torch(k), _torch(v), causal=True)
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(to), _np(jo), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("tq,tk", [(64, 96), (64, 32)])
def test_bwd_parts_top_left_causal_matches_jax(tq, tk):
    rng = np.random.RandomState(tq + tk)
    q, do = (rng.randn(4, tq, 16).astype(np.float32) * 0.5 for _ in range(2))
    k, v = (rng.randn(4, tk, 16).astype(np.float32) * 0.5 for _ in range(2))
    # a global lse / delta as a ring hop would get them: any finite rows do
    lse = (rng.rand(4, tq, 1) * 2 + 1).astype(np.float32)
    delta = (rng.randn(4, tq, 1) * 0.1).astype(np.float32)
    jg = jflash.flash_bwd_parts(*map(_jax, (q, k, v, do, lse, delta)),
                                causal=True, block_q=32, block_k=16,
                                interpret=True)
    tg = flash_bwd_parts(*map(_torch, (q, k, v, do, lse, delta)), causal=True)
    for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
        assert a.shape == b.shape
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_the_ports_dense_attention(causal):
    q, k, v = _qkv(t=80, h=3, dh=32, seed=7)
    fq, fk, fv = (_torch(x, grad=True) for x in (q, k, v))
    dq, dk, dv = (_torch(x, grad=True) for x in (q, k, v))
    out = flash_attention(fq, fk, fv, causal)
    ref = multihead_attention(dq, dk, dv, causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)
    g = torch.from_numpy(np.random.RandomState(8).randn(*out.shape).astype(np.float32))
    (out * g).sum().backward()
    (ref * g).sum().backward()
    for a, b in ((fq, dq), (fk, dk), (fv, dv)):
        np.testing.assert_allclose(_np(a.grad), _np(b.grad), rtol=2e-4, atol=2e-4)
