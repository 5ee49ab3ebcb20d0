"""Parity of the port's GPT-2 (deepspeed_tpu_torch/models/gpt2.py) with the
JAX package's, through the parameter bridge (inference/weights.py).

``GPT2Config.tiny(max_seq_len=64)`` parameters from the JAX ``init``
(PRNGKey(0), f32) are copied to the port with ``gpt2_params_from_numpy``;
both packages then compute ``apply``'s loss and the gradient of every
parameter (torch autograd against ``jax.grad``) on the same numpy batch,
dense and flash (the JAX flash path runs its Pallas kernels in interpret
mode, the port's its plain versions).

Tolerances: with ``compute_dtype=float32`` on both sides, the loss within
1e-5 relative and each gradient within 1e-5 of its own max |g| (the same
f32 math; exp/tanh/rsqrt and summation order differ in the last bits;
measured 8e-8 and 8e-7). With the bf16 default, the loss within 1e-3
relative and each gradient within 5e-2 of its max |g|: every matmul and
norm output is rounded to bf16 and the two libraries round at slightly
different points (one bf16 ulp is 2^-8 = 4e-3 relative, and the backward
chains a few dozen such roundings; measured 1.3e-5 and 2.2e-2).

The cached inference path (``init_cache`` / ``forward_with_cache``): a
prefill and single-token decode steps at a scalar index, and a decode step
at a per-slot index, give the JAX package's logits within 1e-5 of max
|logit| in fp32 (the JAX cache is token-pair packed for Dh < 128 at batch
>= 2; only logits are compared, never cache layouts).

``init`` is checked by its statistics, since torch's generator does not
give JAX's numbers: shapes equal the JAX tree's, weights have std 0.02
within 3%, the residual output projections std 0.02 / sqrt(2L), biases
zero and layer-norm scales one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.inference.weights import (gpt2_params_from_numpy,
                                                   numpy_from_params)
from deepspeed_tpu_torch.models.base import make_causal_lm_batch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.utils.tree import tree_leaves

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-3, 5e-2)}


def _batch(seed=0, b=2, t=32, vocab=512):
    rng = np.random.RandomState(seed)
    start = rng.randint(0, vocab, size=(b, 1))
    step = rng.randint(1, 7, size=(b, 1))
    ids = ((start + step * np.arange(t + 1)) % vocab).astype(np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _pair(attn_impl, dtype):
    jdt, tdt = DTYPES[dtype]
    jm = JGPT2Model(JGPT2Config.tiny(max_seq_len=64), compute_dtype=jdt,
                    attn_impl=attn_impl)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = GPT2Model(GPT2Config.tiny(max_seq_len=64), compute_dtype=tdt,
                   attn_impl=attn_impl)
    tparams = gpt2_params_from_numpy(jax.device_get(jparams), "cpu")
    return jm, jparams, tm, tparams


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_loss_and_every_gradient_match_jax(attn_impl, dtype):
    jm, jparams, tm, tparams = _pair(attn_impl, dtype)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jm.apply(p, jb, train=True)[0]

    jl, jg = jax.value_and_grad(jloss)(jparams)
    for p in tree_leaves(tparams):
        p.requires_grad_()
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tl, metrics = tm.apply(tparams, tb, train=True)
    tl.backward()
    assert int(metrics["ntokens"]) == batch["labels"].size
    loss_tol, grad_tol = TOL[dtype]
    assert abs(float(tl) - float(jl)) <= loss_tol * abs(float(jl))
    jflat = jax.tree_util.tree_leaves_with_path(jax.device_get(jg))
    tgrads = numpy_from_params({k: v for k, v in _grads(tparams).items()})
    for path, want in jflat:
        got = tgrads
        for key in path:
            got = got[key.key]
        want = np.asarray(want, np.float32)
        err = np.abs(got - want).max()
        assert err <= grad_tol * np.abs(want).max(), (path, err, np.abs(want).max())


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad


def test_flash_and_dense_give_the_same_loss():
    _, _, dense, params = _pair("dense", "float32")
    flash = GPT2Model(GPT2Config.tiny(max_seq_len=64),
                      compute_dtype=torch.float32, attn_impl="flash")
    tb = {k: torch.from_numpy(v).long() for k, v in _batch(1).items()}
    a = dense.apply(params, tb)[0]
    b = flash.apply(params, tb)[0]
    assert abs(float(a) - float(b)) <= 1e-5 * abs(float(a))


def test_init_statistics_match_the_reference_distributions():
    cfg = dict(vocab_size=2048, max_seq_len=256, num_layers=4,
               hidden_size=128, num_heads=4)
    jshapes = jax.eval_shape(JGPT2Model(JGPT2Config(**cfg)).init,
                             jax.random.PRNGKey(0))
    params = GPT2Model(GPT2Config(**cfg)).init(
        torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_leaves_with_path(jshapes)
    assert len(jflat) == len(tree_leaves(params))
    out_std = 0.02 / np.sqrt(2 * cfg["num_layers"])
    for path, sds in jflat:
        leaf = params
        for key in path:
            leaf = leaf[key.key]
        name = path[-1].key
        assert tuple(leaf.shape) == tuple(sds.shape), name
        assert leaf.dtype == torch.float32
        if name.endswith("_b") or name.endswith("_bias"):
            assert torch.count_nonzero(leaf) == 0, name
        elif name.endswith("_scale"):
            assert torch.all(leaf == 1), name
        else:
            want = out_std if name in ("attn_out_w", "mlp_out_w") else 0.02
            std = float(leaf.std())
            assert abs(std - want) <= 0.03 * want, (name, std, want)
            assert abs(float(leaf.mean())) <= 0.05 * want, name


def test_make_causal_lm_batch_matches_jax():
    from deepspeed_tpu.models.base import make_causal_lm_batch as jmake

    ids = np.arange(20, dtype=np.int32).reshape(2, 10)
    got, want = make_causal_lm_batch(torch.from_numpy(ids)), jmake(jnp.asarray(ids))
    for k in ("input_ids", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_options_not_ported_raise():
    cfg = GPT2Config.tiny()
    # remat and loss_chunk are ported (tests/test_torch_llama_train.py)
    assert GPT2Model(cfg, remat=True).remat
    with pytest.raises(ValueError):            # as the reference
        GPT2Model(GPT2Config.tiny(loss_chunk=16, tie_embeddings=False))
    for impl in ("ring", "ring_flash", "ulysses"):
        with pytest.raises(NotPortedError):
            GPT2Model(cfg, attn_impl=impl)
    with pytest.raises(ValueError):            # as the reference
        GPT2Model(GPT2Config.tiny(dropout=0.1), attn_impl="flash")
    m = GPT2Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    ids = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotPortedError):
        m.forward_hidden(params, ids, pld_theta=0.5)
    with pytest.raises(NotPortedError):
        m.forward_hidden(params, ids, ltd_keep=4)


@pytest.mark.parametrize("preset", ["tiny", "gpt2_774m", "gpt2_1b3"])
def test_flops_per_token_matches_jax(preset):
    jm = JGPT2Model(getattr(JGPT2Config, preset)())
    tm = GPT2Model(getattr(GPT2Config, preset)())
    assert tm.flops_per_token() == jm.flops_per_token()
    c = tm.config
    # at T tokens per sequence only the attention term moves
    assert (tm.flops_per_token(c.max_seq_len // 2) - tm.flops_per_token()
            == -12 * c.num_layers * c.hidden_size * (c.max_seq_len // 2))


def test_cached_prefill_and_decode_logits_match_jax():
    jm, jparams, tm, tparams = _pair("dense", "float32")
    rng = np.random.RandomState(4)
    b, t, steps, max_len = 2, 10, 3, 128
    ids = rng.randint(0, 512, (b, t + steps)).astype(np.int32)
    jfwd = jax.jit(jm.forward_with_cache)
    jcache = jm.init_cache(b, max_len, dtype=jnp.float32)
    tcache = tm.init_cache(b, max_len, dtype=torch.float32)

    def close(tlog, jlog):
        want = np.asarray(jlog, np.float32)
        err = np.abs(tlog.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err

    with torch.no_grad():
        for lo, hi in [(0, t)] + [(t + i, t + i + 1) for i in range(steps)]:
            jlog, jcache = jfwd(jparams, jnp.asarray(ids[:, lo:hi]), jcache)
            tlog, tcache = tm.forward_with_cache(
                tparams, torch.from_numpy(ids[:, lo:hi]).long(), tcache)
            close(tlog, jlog)
            assert int(jcache["index"]) == tcache["index"] == hi
        # one more step at a per-slot index: row 1 rewinds two positions
        lens = np.array([t + steps, t + steps - 2], np.int32)
        nxt = rng.randint(0, 512, (b, 1)).astype(np.int32)
        jlog, _ = jfwd(jparams, jnp.asarray(nxt),
                       dict(jcache, index=jnp.asarray(lens)))
        tlog, _ = tm.forward_with_cache(
            tparams, torch.from_numpy(nxt).long(),
            dict(tcache, index=torch.from_numpy(lens)))
        close(tlog, jlog)
