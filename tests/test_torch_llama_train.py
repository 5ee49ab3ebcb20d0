"""LLaMA training in the port (models/llama.py ``apply`` and
``flops_per_token``), activation checkpointing
(runtime/activation_checkpointing.py, ``remat=True`` on LLaMA and GPT-2),
the chunked LM loss (runtime/zero/tiling.py, ``GPT2Config(loss_chunk>0)``)
and the flash kernels' f32-precise mode, against the JAX package on the CPU.

Inputs come from numpy with a seed and go to both packages; the port runs
on the CPU (each kernel's plain version), the JAX package on its CPU
backend (its Pallas flash kernels in interpret mode).

Tolerances, and why:

* LLaMA ``apply`` at fp32: loss within 1e-5 and every gradient within 1e-4
  of its leaf's largest value (the same f32 math in two libraries; the JAX
  flash kernel's online softmax over tiles against the plain version's one
  pass changes only the summation order);
* remat: every policy gives the same loss and gradients as no remat, bit
  for bit (the recompute runs the same f32 ops in the same order), and the
  flash forward runs once a layer under ``"save_attn"``, ``"everything"``
  and no remat, twice under the others;
* the chunked loss and ``tiled_linear`` at fp32: within 1e-5 relative of
  the reference (the same math; only the order of the sums moves), the
  chunked GPT-2 within 1e-5 of the unchunked one;
* the precise mode with bf16 operands: each output within one bf16 ulp
  (at most 2^-7 of the value, the output rounding) of the JAX kernel
  under the same flag, and nearer an f64 evaluation of the same function
  than the default mode (p and dS rounded to bf16); over every element,
  the default's mean error against an f64 evaluation is at least
  ``kernel_check.PRECISE_GAIN`` (1.1) times the precise one's, in bf16
  and fp16 (rounding p or dS as the default does gives about 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.flash_attention as jflash
import deepspeed_tpu.runtime.activation_checkpointing as jac
import deepspeed_tpu.runtime.zero.tiling as jtiling
import deepspeed_tpu_torch
import deepspeed_tpu_torch.ops.flash_attention as tflash
import deepspeed_tpu_torch.ops.kernel_check as kernel_check
import deepspeed_tpu_torch.runtime.activation_checkpointing as tac
import deepspeed_tpu_torch.runtime.zero.tiling as ttiling
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu_torch.inference.weights import llama_params_from_numpy
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

T = 32
POLICIES = [None, "nothing", "everything", "dots", "dots_no_batch",
            "checkpoint_dots", "offload_dots", "save_attn"]


def _ids(b=2, t=T, vocab=512, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(b, t + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _leaves(params):
    return tree_map(lambda p: p.detach().clone().requires_grad_(), params)


def _grads(model, params, batch):
    leaves = _leaves(params)
    loss, _ = model.apply(leaves, _tbatch(batch), train=True)
    loss.backward()
    return loss.detach(), tree_map(lambda p: p.grad, leaves)


@pytest.fixture(scope="module")
def jax_llama():
    jm = JLlamaModel(JLlamaConfig.tiny(max_seq_len=T), compute_dtype=jnp.float32)
    p = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    return p, llama_params_from_numpy(p, "cpu", torch.float32)


# ------------------------------------------------------------------ LLaMA
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_apply_loss_and_gradients_match_jax(jax_llama, attn_impl):
    jp, tp = jax_llama
    batch = _ids(seed=1)
    jm = JLlamaModel(JLlamaConfig.tiny(max_seq_len=T), compute_dtype=jnp.float32,
                     attn_impl=attn_impl)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.apply(p, jax.tree_util.tree_map(jnp.asarray, batch),
                           train=True), has_aux=True)(jp)
    tm = LlamaModel(LlamaConfig.tiny(max_seq_len=T), compute_dtype=torch.float32,
                    attn_impl=attn_impl)
    tl, tg = _grads(tm, tp, batch)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for path, want in jax.tree_util.tree_leaves_with_path(jax.device_get(jg)):
        got = tg
        for key in path:
            got = got[key.key]
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (path, err)


@pytest.mark.parametrize("preset", ["tiny", "llama_7b", "tinyllama"])
def test_flops_per_token_matches_jax(preset):
    kw = {}
    if preset == "tinyllama":     # TinyLlama-1.1B's config.json widths
        preset, kw = "tiny", dict(vocab_size=32000, hidden_size=2048,
                                  intermediate_size=5632, num_layers=22,
                                  num_heads=32, num_kv_heads=4, max_seq_len=2048)

    def make(cls):
        if kw:
            return cls(**kw)
        return getattr(cls, preset)()

    jm, tm = JLlamaModel(make(JLlamaConfig)), LlamaModel(make(LlamaConfig))
    assert tm.flops_per_token() == jm.flops_per_token()
    c = tm.config
    assert (tm.flops_per_token(T) - tm.flops_per_token(2 * T)
            == -12 * c.num_layers * c.hidden_size * T)


# ------------------------------------------------------------------ remat
def _count_flash_forwards(monkeypatch):
    calls = [0]
    plain = tflash.flash_fwd_parts_plain

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(tflash, "flash_fwd_parts_plain", counted)
    return calls


@pytest.fixture(scope="module")
def llama_no_remat(jax_llama):
    _, tp = jax_llama
    tm = LlamaModel(LlamaConfig.tiny(max_seq_len=T), compute_dtype=torch.float32,
                    attn_impl="flash")
    return _grads(tm, tp, _ids(seed=2))


@pytest.mark.parametrize("policy", POLICIES)
def test_every_remat_policy_gives_the_gradients_of_no_remat(
        jax_llama, llama_no_remat, monkeypatch, policy):
    _, tp = jax_llama
    calls = _count_flash_forwards(monkeypatch)
    tm = LlamaModel(LlamaConfig.tiny(max_seq_len=T), compute_dtype=torch.float32,
                    attn_impl="flash", remat=True, remat_policy=policy)
    loss, grads = _grads(tm, tp, _ids(seed=2))
    want_loss, want = llama_no_remat
    assert torch.equal(loss, want_loss)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert torch.equal(g, w)
    layers = tm.config.num_layers
    once = policy in ("everything", "save_attn")
    assert calls[0] == (layers if once else 2 * layers), (policy, calls[0])


def test_save_attn_keeps_flash_residuals_only_across_a_block_seam(monkeypatch):
    """``"save_attn"`` keeps the flash call's residuals where a block is split
    around attention (checkpoint_block, as the models run it); a function
    given whole to checkpoint_wrapper has no seam, keeps its products only
    and runs the flash forward again in the backward."""
    calls = _count_flash_forwards(monkeypatch)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 24, 2, 16, generator=g, requires_grad=True)
    w = torch.randn(16, 16, generator=g)

    def pre(x):
        return x @ w, torch.tanh(x), x

    def post(x, attn):
        return (attn @ w + x).sum()

    def whole(x):
        return post(x, tflash.flash_attention(*pre(x), True))

    want = torch.autograd.grad(whole(x), x)[0]
    assert calls[0] == 1
    split = tac.checkpoint_block(
        pre, lambda q, k, v: tflash.flash_attention(q, k, v, True), post,
        policy="save_attn")
    for fn, forwards in ((split, 1),
                         (tac.checkpoint_wrapper(whole, policy="save_attn"), 2)):
        calls[0] = 0
        assert torch.equal(torch.autograd.grad(fn(x), x)[0], want)
        assert calls[0] == forwards, (fn, calls[0])


@pytest.mark.parametrize("policy", [None, "dots_no_batch", "save_attn"])
def test_gpt2_remat_replays_dropout(policy):
    cfg = GPT2Config.tiny(max_seq_len=T, dropout=0.1)
    params = GPT2Model(cfg).init(torch.Generator().manual_seed(0))
    out = []
    for remat in (False, True):
        m = GPT2Model(cfg, compute_dtype=torch.float32, remat=remat,
                      remat_policy=policy)
        leaves = _leaves(params)
        loss, _ = m.apply(leaves, _tbatch(_ids(seed=4)), train=True,
                          rngs={"dropout": torch.Generator().manual_seed(9)})
        loss.backward()
        out.append((loss.detach(), [p.grad for p in tree_leaves(leaves)]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_policy_names_and_configure_follow_the_reference():
    jnames = {k for k in jac._build_policies() if k}
    assert {k for k in tac.POLICIES if k} == jnames | {"offload_dots", "save_attn"}
    for mod in (jac, tac):
        with pytest.raises(ValueError, match="unknown remat policy"):
            mod.checkpoint_policy("bogus")
    saved = tac._config
    try:
        tac.configure(checkpoint_in_cpu=True)
        assert tac.is_configured() and tac.get_config().cpu_checkpointing
        assert tac.checkpoint_policy(None).name == "offload_dots"
        x = torch.randn(4, 8, requires_grad=True)
        w = torch.randn(8, 8)
        y = tac.checkpoint(lambda a: torch.tanh(a @ w) @ w, x)
        y.sum().backward()
        g = x.grad.clone()
        x.grad = None
        (torch.tanh(x @ w) @ w).sum().backward()
        assert torch.equal(g, x.grad)
    finally:
        tac._config = saved


def test_engine_trains_llama_with_remat_like_without():
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "steps_per_print": 0, "activation_checkpointing": {"policy": "dots"}}
    losses = []
    for remat in (False, True):
        m = LlamaModel(LlamaConfig.tiny(max_seq_len=T), compute_dtype=torch.float32,
                       attn_impl="flash", remat=remat, remat_policy="save_attn")
        eng, *_ = deepspeed_tpu_torch.initialize(model=m, config=cfg, device="cpu")
        batches = [_ids(b=4, seed=10 + i) for i in range(3)]
        losses.append([float(eng.train_batch_from_stacked(
            {k: v.reshape(2, 2, T) for k, v in b.items()})) for b in batches])
    assert losses[0] == losses[1]


# ------------------------------------------------------------ chunked loss
@pytest.mark.parametrize("chunk", [8, 12, 64])
def test_chunked_cross_entropy_matches_jax(chunk):
    rng = np.random.RandomState(chunk)
    h = rng.randn(2, 20, 16).astype(np.float32)
    e = (rng.randn(40, 16) * 0.3).astype(np.float32)
    lab = rng.randint(0, 40, size=(2, 20)).astype(np.int32)
    lab[0, :3] = -100

    def jloss(h, e):
        return jtiling.chunked_cross_entropy(h, e, jnp.asarray(lab), chunk=chunk)[0]

    (jl, jn) = jtiling.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(e),
                                             jnp.asarray(lab), chunk=chunk)
    jgh, jge = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(e))
    th, te = (torch.from_numpy(x).requires_grad_() for x in (h, e))
    tl, tn = ttiling.chunked_cross_entropy(th, te, torch.from_numpy(lab).long(),
                                           chunk=chunk)
    tl.backward()
    assert int(tn) == int(jn) == 37
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for got, want in ((th.grad, jgh), (te.grad, jge)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("out_tiles,in_tiles", [(1, 1), (4, 1), (1, 4), (2, 2)])
def test_tiled_linear_matches_jax(out_tiles, in_tiles):
    rng = np.random.RandomState(out_tiles * 10 + in_tiles)
    x = rng.randn(3, 5, 32).astype(np.float32)
    w = rng.randn(32, 24).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    want = np.asarray(jtiling.tiled_linear(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b), out_tiles=out_tiles,
                                           in_tiles=in_tiles))
    got = ttiling.tiled_linear(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), out_tiles=out_tiles,
                               in_tiles=in_tiles)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_gpt2_loss_chunk_matches_the_unchunked_loss():
    cfg = GPT2Config.tiny(max_seq_len=T)
    params = GPT2Model(cfg).init(torch.Generator().manual_seed(1))
    batch = _ids(seed=6)
    batch["labels"][1, 5:9] = -100
    out = [_grads(GPT2Model(GPT2Config.tiny(max_seq_len=T, loss_chunk=chunk),
                            compute_dtype=torch.float32), params, batch)
           for chunk in (0, 12)]
    (l0, g0), (l1, g1) = out
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5 * float(a.abs().max()))


# ---------------------------------------------------------- precise mode
def _flat(b, h, t, dh, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b * h, t, dh).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
def test_precise_plain_versions_match_the_jax_kernels(monkeypatch, causal):
    q, k, v, do = _flat(1, 2, 48, 16, seed=int(causal))
    to_bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    tq, tk, tv, tdo = map(to_bf, (q, k, v, do))
    f64 = [t.double() for t in (tq, tk, tv, tdo)]

    def run(precise):
        out, lse = tflash.flash_fwd_parts(tq, tk, tv, causal=causal)
        delta = (tdo.float() * out.float()).sum(-1, keepdim=True)
        grads = tflash.flash_bwd_parts(tq, tk, tv, tdo, lse, delta, causal=causal)
        return (out,) + grads, lse, delta

    default, _, _ = run(False)
    monkeypatch.setenv("DSTPU_FLASH_F32_PRECISE", "1")
    jax.clear_caches()
    precise, lse, delta = run(True)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jo, jlse = jflash.flash_fwd_parts(jq, jk, jv, causal=causal, block_q=16,
                                      block_k=16, interpret=True)
    jgrads = jflash.flash_bwd_parts(jq, jk, jv, jdo, jnp.asarray(lse.numpy()),
                                    jnp.asarray(delta.numpy()), causal=causal,
                                    block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)
    # f64 evaluation of the function both modes compute
    ref_o, ref_lse = tflash.flash_fwd_parts_plain(*f64[:3], causal=causal,
                                                  precise=True)
    ref_g = tflash.flash_bwd_parts(*f64, ref_lse, (f64[3] * ref_o).sum(-1, keepdim=True),
                                   causal=causal)
    for name, got, want, dflt, ref in zip(
            ("o", "dq", "dk", "dv"), precise, (jo,) + tuple(jgrads), default,
            (ref_o,) + tuple(ref_g)):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -8 * np.abs(want).max(), err_msg=name)
        err_p = (got.double() - ref).abs().max()
        err_d = (dflt.double() - ref).abs().max()
        assert err_p < err_d, (name, float(err_p), float(err_d))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bh,t,dh,causal", [(3, 77, 128, True),
                                            (3, 130, 64, False)])
def test_precise_mode_is_nearer_f64_than_the_default(dtype, bh, t, dh, causal):
    """The plain versions with p and dS in f32 against the same with them
    rounded to the 16-bit storage dtype: the default's mean error against
    kernel_check's f64 evaluation is PRECISE_GAIN times the precise one's
    or more, the margin the card holds the kernels to."""
    q, k, v, do = kernel_check.flash_inputs("cpu", dtype, bh, t, dh, seed=t)

    def run(precise):
        o, lse = tflash.flash_fwd_parts_plain(q, k, v, causal=causal,
                                              precise=precise)
        delta = kernel_check.flash_delta(do, o)
        return (o, tflash.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                             causal=causal, precise=precise),
                *tflash.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                            causal=causal, precise=precise))

    errs = [kernel_check.flash_mean_errors_f64(run(p), q, k, v, do,
                                               causal=causal, group=2)
            for p in (True, False)]
    for name, ep, ed in zip(("o", "dq", "dk", "dv"), *errs):
        assert ed >= kernel_check.PRECISE_GAIN * ep, (name, ep, ed)


def test_precise_wrappers_take_the_plain_version_on_the_cpu():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _flat(1, 1, 24, 16, seed=3))
    o, lse = tflash.flash_fwd_precise(q, k, v, causal=True)
    want_o, want_lse = tflash.flash_fwd_parts_plain(q, k, v, causal=True,
                                                    precise=True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = tflash.flash_bwd_dq_precise(q, k, v, do, lse, delta, causal=True)
    dk, dv = tflash.flash_bwd_dkv_precise(q, k, v, do, lse, delta, causal=True)
    assert torch.equal(dq, tflash.flash_bwd_dq_plain(
        q, k, v, do, lse, delta, causal=True, precise=True))
    for a, b in zip((dk, dv), tflash.flash_bwd_dkv_plain(
            q, k, v, do, lse, delta, causal=True, precise=True)):
        assert torch.equal(a, b)
    assert tflash.flash_fwd_precise.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_fwd_precise(q.to("meta"), k.to("meta"), v.to("meta"),
                                 causal=True)
