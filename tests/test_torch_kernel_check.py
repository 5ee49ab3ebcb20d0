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
* The decode steps are held by the same metric: at the LLaMA-7B decode
  shape, a split of the cache left out of the merge is rejected, including
  the variant an absolute 2e-2 bound on the output passes.
* So is the block-sparse dK/dV kernel's merge of partials: at a GPT-style
  causal layout whose global columns are cut in two parts, dK summed from
  its parts passes the sparse bound (1.6e-2 in bf16), and dK with one
  part's partial left out is rejected. Its plain versions run in one
  intra-op thread: about 4,500 ops on [1, 2, 128, 16, 64] blocks, each of
  which paid a thread barrier under torch's default team, 188 s on a host
  loaded by six pytest workers where one thread takes about 2.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.flash_attention as jflash
from deepspeed_tpu_torch.ops.decode_step import fused_decode_step_plain
from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_dkv_plain,
                                                     flash_bwd_dq_plain,
                                                     flash_fwd_parts_plain)
from deepspeed_tpu_torch.ops.kernel_check import (dkv_by_parts, flash_delta,
                                                  flash_inputs, rel_err)
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as tbs
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

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


# The fused decode step (kernel B) at chip_smoke's LLaMA-7B row: 8 slots x
# 32 heads x Dh 128, S 1024. Slot 7 attends over 1001 positions, so its
# output rows average about a thousand values and are small (max |x| ~ 0.2).
_DECODE_IDX = [0, 1023, 1024, 17, 500, 733, 256, 1000]


def _decode_7b():
    rng = np.random.RandomState(0)

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            torch.bfloat16)

    b, hq, s, dh = 8, 32, 1024, 128
    q, kn, vn = rnd(b, 1, hq, dh), rnd(b, 1, hq, dh), rnd(b, 1, hq, dh)
    kf, vf = rnd(2, b, hq, s, dh), rnd(2, b, hq, s, dh)
    idx = torch.tensor(_DECODE_IDX, dtype=torch.int32)
    ref, kf, vf = fused_decode_step_plain(q, kf, vf, kn, vn, 1, idx)
    # the probabilities of slot 7 (idx 1000) as the plain version computes
    # them, for the wrong variants below
    qs, kl, vl = q[7, 0].float(), kf[1, 7].float(), vf[1, 7].float()
    sc = torch.einsum("hd,hsd->hs", qs, kl)[:, :1001] * dh ** -0.5
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    return ref, p, vl[:, :1001]


def _slot7(ref, p, v, l):
    bad = ref.clone()
    pv = torch.einsum("hs,hsd->hd", p.to(torch.bfloat16).float(), v)
    bad[7, 0] = (pv / l[:, None]).to(torch.bfloat16)
    return bad


def test_decode_step_one_split_left_out_is_rejected():
    """Slot 7 with positions 512..575 (one 64-position chunk) left out of
    both sums, as a split that never ran would leave them: rel_err rejects
    it; so does the old absolute bound at this shape (the error, 0.074, is
    a third of the row's largest element)."""
    ref, p, v = _decode_7b()
    keep = torch.ones(p.shape[-1], dtype=torch.bool)
    keep[512:576] = False
    pk = p * keep
    bad = _slot7(ref, pk, v, pk.sum(-1))
    assert rel_err(bad, ref) > 2 * BF16_TOL
    assert (bad.float() - ref.float()).abs().max() > BF16_TOL


def test_decode_step_one_split_left_out_of_l_is_rejected():
    """Slot 7 with that chunk's probabilities left out of the denominator
    only, as a merge that drops one split's l would: every entry of the
    slot's rows is about 6% off, which the old absolute bound of 2e-2
    passes (its error is 0.013) and rel_err rejects."""
    ref, p, v = _decode_7b()
    keep = torch.ones(p.shape[-1], dtype=torch.bool)
    keep[512:576] = False
    bad = _slot7(ref, p, v, (p * keep).sum(-1))
    assert rel_err(bad, ref) > BF16_TOL
    assert (bad.float() - ref.float()).abs().max() <= BF16_TOL


SPARSE_BF16_TOL = 1.6e-2


@contextlib.contextmanager
def _one_intra_op_thread():
    """torch's intra-op team cut to one thread for the block (the ops are
    too small to gain from more), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_sparse_dkv_one_partial_left_out_is_rejected():
    """Layout (a)'s pattern (Fixed, 4 local, 1 global, unidirectional, block
    16) at T 2048, bf16, Dh 64: the global column of key block 3 holds 125
    query blocks, two parts of the work list. dK summed from all parts is
    within the bound of the plain version; with that column's second part
    left out it is rejected."""
    with _one_intra_op_thread():
        _sparse_dkv_one_partial_left_out_is_rejected()


def _sparse_dkv_one_partial_left_out_is_rejected():
    t, blk, h = 2048, 16, 2
    layout = FixedSparsityConfig(num_heads=h, block=blk, num_local_blocks=4,
                                 num_global_blocks=1,
                                 attention="unidirectional").make_layout(t)
    luts = tbs.sparse_luts(layout, "cpu")
    assert int(luts.cnt_k[0, 3]) == 125
    qf, kf, vf, dof = flash_inputs("cpu", torch.bfloat16, h, t, 64, seed=7)
    out, lse = tbs.block_sparse_fwd_plain(qf, kf, vf, luts, block=blk,
                                          causal=True)
    delta = tbs.block_sparse_delta(dof, out)
    kw = dict(block=blk, causal=True)
    ref, _ = tbs.block_sparse_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, luts,
                                            **kw)
    good, _ = dkv_by_parts(qf, kf, vf, dof, lse, delta, luts, part=64, **kw)
    bad, _ = dkv_by_parts(qf, kf, vf, dof, lse, delta, luts, part=64,
                          drop={(3, 1)}, **kw)
    assert rel_err(good, ref) <= SPARSE_BF16_TOL
    assert rel_err(bad, ref) > 2 * SPARSE_BF16_TOL
