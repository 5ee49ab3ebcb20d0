"""Parity of the port's LLaMA (deepspeed_tpu_torch/models/llama.py) with the
JAX package's, through the weight bridge (inference/weights.py).

The JAX ``LlamaModel`` parameters (from ``init(PRNGKey(0))``, cast to the
serving dtype) are carried to the port with ``llama_params_from_numpy``.
Both sides then run: the no-cache forward; the serving flow of a slot
cache — a batch-1 bucket prefill per slot (``forward_with_cache`` with a
scalar index), ``write_slot_prefix``, and decode steps with a per-slot
index vector; and the final cache contents. Configs: ``LlamaConfig.tiny()``
(GQA rep 2, Dh 16) and a narrow Dh-128 MHA config.

Tolerances, relative to max |logit| (logits are O(0.1-1) here): f32 1e-5
(the same f32 math summed in different orders; measured ~1e-6); bf16 2e-2
(bf16 rounds every matmul and norm output, and the two libraries round the
same quantities at slightly different points: measured one bf16 ulp,
2^-8 relative, over two layers). Caches: f32 atol 1e-5, bf16 atol 2e-2.
The bridge itself is bit-exact. The shared layers (models/base, ops/rotary,
multihead_attention) are held one by one in f32 within 1e-5 relative to
their output's max (the same f32 formula; exp/rsqrt/tanh and summation
order differ in the last bits), and the integer-valued ones exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.models.base as jbase
import deepspeed_tpu.ops.attention as jattn
import deepspeed_tpu.ops.rotary as jrot
import deepspeed_tpu_torch.models.base as tbase
import deepspeed_tpu_torch.ops.attention as tattn
import deepspeed_tpu_torch.ops.rotary as trot
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu.ops.attention import write_slot_prefix as jax_write_slot_prefix
from deepspeed_tpu_torch.inference.weights import llama_params_from_numpy
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.ops.attention import write_slot_prefix

CONFIGS = {
    "tiny_gqa_dh16": dict(),
    "narrow_mha_dh128": dict(vocab_size=256, num_layers=2, hidden_size=256,
                             num_heads=2, num_kv_heads=2,
                             intermediate_size=256),
}
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
BUCKET, MAX_LEN = 16, 128


def _pair(name, dtype):
    kw = CONFIGS[name]
    jcfg = JLlamaConfig.tiny() if not kw else JLlamaConfig(max_seq_len=128, **kw)
    tcfg = LlamaConfig.tiny() if not kw else LlamaConfig(max_seq_len=128, **kw)
    jdt = jnp.dtype(dtype)
    jm = JLlamaModel(jcfg, compute_dtype=jdt)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jdt),
                                     jm.init(jax.random.PRNGKey(0)))
    tdt = getattr(torch, dtype)
    tm = LlamaModel(tcfg, compute_dtype=tdt)
    tparams = llama_params_from_numpy(jax.device_get(jparams), "cpu", tdt)
    return jm, jparams, tm, tparams


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_rel(out, ref, rel):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = _np(ref)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def test_weight_bridge_is_bit_exact():
    _, jparams, _, tparams = _pair("tiny_gqa_dh16", "bfloat16")
    jflat = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in jflat:
        node = tparams
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.bfloat16
        np.testing.assert_array_equal(node.float().numpy(), _np(leaf))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_match_jax(name, dtype):
    jm, jparams, tm, tparams = _pair(name, dtype)
    ids = np.random.RandomState(1).randint(0, jm.config.vocab_size, (2, 12))
    ref = jax.jit(lambda p, i: jm.logits(p, jm.forward_hidden(p, i)))(
        jparams, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        out = tm.logits(tparams, tm.forward_hidden(
            tparams, torch.from_numpy(ids).long()))
    _close_rel(out, ref, TOL[dtype][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_slot_prefill_and_per_slot_decode_match_jax(name, dtype):
    """The serving engine's numerics, step by step: each slot prefills its
    own prompt in a batch-1 bucket cache, is inserted into the slot cache,
    and then all slots decode together at their own lengths."""
    jm, jparams, tm, tparams = _pair(name, dtype)
    cfg = jm.config
    rng = np.random.RandomState(2)
    lens = [5, 16, 9]
    nslots, steps = len(lens), 4
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jslot = jm.init_cache(nslots, MAX_LEN, dtype=jdt)
    tslot = tm.init_cache(nslots, MAX_LEN, dtype=tdt)
    jfwd = jax.jit(jm.forward_with_cache)
    last_tok = []
    with torch.no_grad():
        for slot, n in enumerate(lens):
            ids = np.zeros((1, BUCKET), np.int64)
            ids[0, :n] = rng.randint(0, cfg.vocab_size, n)
            jlog, jc = jfwd(jparams, jnp.asarray(ids, jnp.int32),
                            jm.init_cache(1, BUCKET, dtype=jdt))
            jslot["k"], jslot["v"] = jax_write_slot_prefix(
                jslot["k"], jslot["v"], jc["k"], jc["v"], slot)
            tlog, tc = tm.forward_with_cache(
                tparams, torch.from_numpy(ids), tm.init_cache(1, BUCKET, tdt))
            write_slot_prefix(tslot["k"], tslot["v"], tc["k"], tc["v"], slot)
            _close_rel(tlog[0, n - 1], jlog[0, n - 1], TOL[dtype][0])
            last_tok.append(int(np.argmax(_np(jlog[0, n - 1]))))
        lengths = np.asarray(lens, np.int32)
        toks = np.asarray(last_tok, np.int64)
        for _ in range(steps):
            jslot["index"] = jnp.asarray(lengths)
            jlog, jout = jfwd(jparams, jnp.asarray(toks[:, None], jnp.int32),
                              jslot)
            jslot["k"], jslot["v"] = jout["k"], jout["v"]
            tslot["index"] = torch.from_numpy(lengths)
            tlog, tout = tm.forward_with_cache(
                tparams, torch.from_numpy(toks[:, None]), tslot)
            assert torch.equal(tout["index"], torch.from_numpy(lengths + 1))
            _close_rel(tlog[:, 0], jlog[:, 0], TOL[dtype][0])
            toks = np.argmax(_np(jlog[:, 0]), -1).astype(np.int64)  # teacher
            lengths = lengths + 1
    shape = tslot["k"].shape
    for key in ("k", "v"):
        ref = _np(jslot[key]).reshape(shape)
        np.testing.assert_allclose(tslot[key].float().numpy(), ref,
                                   atol=TOL[dtype][1], rtol=0)


def _layer_cases():
    """name -> (jax fn, torch fn) over the same numpy inputs."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 32).astype(np.float32)
    scale, bias = rng.randn(32).astype(np.float32), rng.randn(32).astype(np.float32)
    ids = rng.randint(0, 50, (2, 5))
    wte = rng.randn(50, 32).astype(np.float32)
    wq = rng.randint(-128, 128, (50, 32)).astype(np.int8)
    ws = (np.abs(rng.randn(50, 1)) * 0.01).astype(np.float32)
    qkv = [rng.randn(2, 6, 4, 16).astype(np.float32) for _ in range(3)]
    labels = rng.randint(0, 32, (2, 5))
    labels[0, 1] = -100
    idx = np.array([3, 40], np.int32)
    t, j = torch.from_numpy, jnp.asarray
    f32 = jnp.float32
    return {
        "rms_norm": (lambda: jbase.rms_norm(j(x), j(scale)),
                     lambda: tbase.rms_norm(t(x), t(scale))),
        "layer_norm": (lambda: jbase.layer_norm(j(x), j(scale), j(bias)),
                       lambda: tbase.layer_norm(t(x), t(scale), t(bias))),
        "gelu": (lambda: jbase.gelu(j(x)), lambda: tbase.gelu(t(x))),
        "embed_tokens": (lambda: jbase.embed_tokens(j(wte), j(ids), f32),
                         lambda: tbase.embed_tokens(t(wte), t(ids), torch.float32)),
        "embed_tokens_int8": (
            lambda: jbase.embed_tokens({"__q__": j(wq), "__scale__": j(ws)}, j(ids), f32),
            lambda: tbase.embed_tokens({"__q__": t(wq), "__scale__": t(ws)}, t(ids),
                                       torch.float32)),
        "tied_logits": (lambda: jbase.tied_logits(j(x), j(wte)),
                        lambda: tbase.tied_logits(t(x), t(wte))),
        "tied_logits_int8": (
            lambda: jbase.tied_logits(j(x), {"__q__": j(wq), "__scale__": j(ws)}),
            lambda: tbase.tied_logits(t(x), {"__q__": t(wq), "__scale__": t(ws)})),
        "cache_positions_scalar": (lambda: jbase.cache_positions(7, 3),
                                   lambda: tbase.cache_positions(7, 3)),
        "cache_positions_per_slot": (lambda: jbase.cache_positions(j(idx), 3),
                                     lambda: tbase.cache_positions(t(idx), 3)),
        "cross_entropy_loss": (
            lambda: jnp.stack(jbase.cross_entropy_loss(j(x), j(labels))).astype(f32),
            lambda: torch.stack([v.float() for v in tbase.cross_entropy_loss(
                t(x), t(labels))])),
        "rope_per_slot": (
            lambda: jrot.apply_rotary_pos_emb(j(qkv[0]), *jrot.rope_frequencies(16, 64),
                                              position_offset=j(idx)),
            lambda: trot.apply_rotary_pos_emb(t(qkv[0]), *trot.rope_frequencies(16, 64),
                                              position_offset=t(idx))),
        "rope_scalar": (
            lambda: jrot.apply_rotary_pos_emb(j(qkv[0]), *jrot.rope_frequencies(16, 64),
                                              position_offset=9),
            lambda: trot.apply_rotary_pos_emb(t(qkv[0]), *trot.rope_frequencies(16, 64),
                                              position_offset=9)),
        "multihead_attention": (
            lambda: jattn.multihead_attention(*map(j, qkv), causal=True),
            lambda: tattn.multihead_attention(*map(t, qkv), causal=True)),
    }


@pytest.mark.parametrize("name", list(_layer_cases()))
def test_shared_layers_match_jax(name):
    jfn, tfn = _layer_cases()[name]
    ref = np.asarray(jfn())
    with torch.no_grad():
        out = tfn().numpy()
    assert out.shape == ref.shape
    if np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(out, ref)
    else:
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max(), name
