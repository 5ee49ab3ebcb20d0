"""The flash kernels' error metric (deepspeed_tpu_torch/ops/kernel_check.py
``rel_err``, used by chip_smoke.py and the card tests at 2e-2 for bf16)
holds a right tiled implementation and rejects a wrong one.

* Right: the JAX package's Pallas flash attention in interpret mode, bf16,
  64 x 64 tiles, rounds p and dS to bf16 at tile-local running maxima, as
  the CUDA kernels do; the port's plain versions round at the row maximum.
  Forward and backward, causal and not, agree within the bound (from the
  same numpy inputs, lse and delta).
* Wrong: at the GPT-2 774M head shape (T 1024, Dh 64, bf16, causal), the
  plain outputs with one late 64-row tile scaled by 0.9, or with one key
  tile left out of the late rows' softmax, are rejected. Late causal rows
  are about sqrt(T) times smaller than row 0, so an error bound relative to
  the whole tensor's max |x| passes the scaled tile; this test pins that
  too, as the reason the metric is per row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.flash_attention as jflash
from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_dkv_plain,
                                                     flash_bwd_dq_plain,
                                                     flash_fwd_parts_plain)
from deepspeed_tpu_torch.ops.kernel_check import (flash_delta, flash_inputs,
                                                  rel_err)

BF16_TOL = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_a_tiled_bf16_implementation_passes(causal):
    rng = np.random.RandomState(3)
    q, k, v, do = (rng.randn(4, 256, 64).astype(np.float32) for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    blocks = dict(block_q=64, block_k=64, interpret=True)
    jo, jl = jflash.flash_fwd_parts(jq, jk, jv, causal=causal, **blocks)
    to, tl = flash_fwd_parts_plain(tq, tk, tv, causal=causal)
    assert rel_err(torch.from_numpy(_np(jo)), to) <= BF16_TOL
    # the backward from one lse and delta (the plain forward's)
    delta = flash_delta(tdo, to)
    jg = jflash.flash_bwd_parts(jq, jk, jv, jdo, jnp.asarray(_np(tl)),
                                jnp.asarray(_np(delta)), causal=causal,
                                **blocks)
    tg = (flash_bwd_dq_plain(tq, tk, tv, tdo, tl, delta, causal=causal),
          *flash_bwd_dkv_plain(tq, tk, tv, tdo, tl, delta, causal=causal))
    for name, j, t in zip(("dq", "dk", "dv"), jg, tg):
        assert rel_err(torch.from_numpy(_np(j)), t) <= BF16_TOL, name


def _causal_774m_head():
    q, k, v, do = flash_inputs("cpu", torch.bfloat16, 2, 1024, 64, seed=5)
    out, lse = flash_fwd_parts_plain(q, k, v, causal=True)
    return q, k, v, do, out, lse


def _max_normalised(out, ref):
    ref = ref.float()
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("which", ["out", "dk", "dv"])
def test_a_late_tile_scaled_by_0_9_is_rejected(which):
    q, k, v, do, out, lse = _causal_774m_head()
    if which == "out":
        ref = out
    else:
        dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, flash_delta(do, out),
                                     causal=True)
        ref = dk if which == "dk" else dv
    bad = ref.clone()
    bad[:, -64:] = (bad[:, -64:].float() * 0.9).to(bad.dtype)
    assert rel_err(bad, ref) > 2 * BF16_TOL
    assert _max_normalised(bad, ref) < BF16_TOL


def test_a_skipped_key_tile_is_rejected():
    q, k, v, _, out, _ = _causal_774m_head()
    # rows from 576 on lose key tile [512, 576), as a kernel that skipped
    # it would
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * 64 ** -0.5
    keep = torch.ones((1024, 1024), dtype=torch.bool).tril()
    keep[576:, 512:576] = False
    s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1)
    bad = torch.matmul(p.to(torch.bfloat16).float(), v.float()).to(v.dtype)
    assert rel_err(bad, out) > 2 * BF16_TOL
