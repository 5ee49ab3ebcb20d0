"""Parity of the port's ``InferenceEngine.generate`` (deepspeed_tpu_torch/
inference/engine.py) with the JAX package's.

Each case builds the JAX engine with ``deepspeed_tpu.init_inference`` and
the port's with ``init_inference(..., device="cpu")`` on the JAX engine's
parameters (carried by the weight bridge, int8 leaves as they are), and
runs the same numpy prompts through both.

* Greedy tokens identical in fp32 (the same f32 math; the port's decode
  steps run the plain versions of the kernels ops/attention.decode_route
  picks, the reference's CPU path the einsum): a small LLaMA at GQA rep 8
  (Dh 16) at batch 1 (the flash-decode route) and batch 2 (the fused
  step), and GPT-2 tiny at batch 2. The same with int8 weight-only block
  matmuls in fp32 compute, and on the EOS path (against JAX's and against
  the port's own rollout without EOS).
* GPT-2 tiny with ``quant.quantize_embedding``: the port quantizes the
  tied table from the same float weights to the same int8 values as the
  reference, with per-row scales within one f32 ulp (XLA's compiled
  ``max / 127`` may round the division the other way), and its no-cache
  logits agree with the JAX engine's within 1e-5 of max |logit| (fp32:
  summation order and those scale ulps).
* ``filter_logits``: the kept set and kept values equal JAX's for top-k,
  top-p and both, on random logits.
* Sampling: torch's generator gives other bits than JAX's, so sampled
  tokens are compared in distribution only (ROADMAP queue 3): a seeded
  generate repeats itself, and 20,000 draws from one filtered
  distribution pass a chi-squared test against its softmax (p > 1e-3;
  the seed is fixed, so the test is deterministic).
* The guards raise the reference's error types on the same arguments.
* A spy shows which plain kernel each decode step runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import deepspeed_tpu
import deepspeed_tpu_torch
import deepspeed_tpu_torch.ops.decode_step as tdecode
import deepspeed_tpu_torch.ops.flash_decode as tflash
from deepspeed_tpu.inference.engine import filter_logits as jax_filter_logits
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.inference.engine import InferenceEngine, filter_logits
from deepspeed_tpu_torch.inference.weights import llama_params_from_numpy
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel

# GQA rep 8 (16 query heads over 2 kv heads of Dh 16)
LLAMA_REP8 = dict(vocab_size=256, max_seq_len=128, num_layers=2,
                  hidden_size=256, num_heads=16, num_kv_heads=2,
                  intermediate_size=256)
MAX_NEW = 8


def _llama(quant=False):
    groups.reset()
    jeng = deepspeed_tpu.init_inference(
        JLlamaModel(JLlamaConfig(**LLAMA_REP8), compute_dtype=jnp.float32),
        dtype="fp32", quant={"enabled": quant})
    params = llama_params_from_numpy(jax.device_get(jeng.params), "cpu",
                                     torch.float32)
    teng = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig(**LLAMA_REP8)), dtype="fp32", device="cpu",
        quant={"enabled": quant}, params=params)
    return jeng, teng


def _gpt2(quant=None, from_float=False):
    """JAX and port GPT-2 tiny engines in fp32; ``quant`` a quant config.
    With ``from_float`` the port gets the JAX engine's float parameters and
    quantizes them itself."""
    groups.reset()
    cfg = dict(quant=quant) if quant else {}
    jeng = deepspeed_tpu.init_inference(
        JGPT2Model(JGPT2Config.tiny(), compute_dtype=jnp.float32),
        dtype="fp32", **cfg)
    src = jeng
    if from_float:
        groups.reset()
        src = deepspeed_tpu.init_inference(
            JGPT2Model(JGPT2Config.tiny(), compute_dtype=jnp.float32),
            dtype="fp32")
    params = llama_params_from_numpy(jax.device_get(src.params), "cpu",
                                     torch.float32)
    teng = deepspeed_tpu_torch.init_inference(
        GPT2Model(GPT2Config.tiny(), compute_dtype=torch.float32),
        dtype="fp32", device="cpu", params=params, **cfg)
    return jeng, teng


def _prompt(b, t, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


def _gen_both(jeng, teng, prompt, **kw):
    want = np.asarray(jeng.generate(prompt, max_new_tokens=MAX_NEW, **kw))
    got = teng.generate(prompt, max_new_tokens=MAX_NEW, **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.shape == (prompt.shape[0], prompt.shape[1] + MAX_NEW)
    return want, got.numpy()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b", [1, 2])
def test_llama_rep8_greedy_tokens_identical(b, quant):
    jeng, teng = _llama(quant)
    if quant:
        assert isinstance(teng.params["blocks"]["wq"], dict)
    want, got = _gen_both(jeng, teng, _prompt(b, 9, 256, seed=b))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quant", [False, True])
def test_gpt2_greedy_tokens_identical(quant):
    jeng, teng = _gpt2({"enabled": True} if quant else None)
    want, got = _gen_both(jeng, teng, _prompt(2, 7, 512, seed=3))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model", ["llama", "gpt2"])
def test_eos_path_matches_jax_and_the_free_rollout(model):
    jeng, teng = _llama() if model == "llama" else _gpt2()
    vocab = teng.module.config.vocab_size
    prompt = _prompt(2, 6, vocab, seed=5)
    free = teng.generate(prompt, max_new_tokens=MAX_NEW).numpy()
    eos = int(free[0, 6 + 2])          # row 0 emits it at step 2
    want, got = _gen_both(jeng, teng, prompt, eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(got, want)
    for row in range(2):
        gen_free, gen_eos = free[row, 6:], got[row, 6:]
        hits = np.where(gen_free == eos)[0]
        stop = hits[0] if len(hits) else MAX_NEW - 1
        np.testing.assert_array_equal(gen_eos[:stop + 1], gen_free[:stop + 1])
        assert (gen_eos[stop + 1:] == 0).all()


def test_eos_stops_the_loop_once_every_row_is_done():
    _, teng = _gpt2()
    prompt = _prompt(1, 6, 512, seed=6)
    free = teng.generate(prompt, max_new_tokens=MAX_NEW).numpy()
    eos = int(free[0, 6 + 1])
    steps = []
    fwd = teng.module.forward_with_cache

    def counting(params, ids, cache):
        steps.append(ids.shape[1])
        return fwd(params, ids, cache)

    teng.module.forward_with_cache = counting
    out = teng.generate(prompt, max_new_tokens=MAX_NEW, eos_token_id=eos,
                        pad_token_id=0).numpy()
    first = int(np.where(free[0, 6:] == eos)[0][0])
    assert (out[0, 6 + first + 1:] == 0).all()
    assert steps == [6] + [1] * first       # prefill, then decode to the EOS


def test_quantize_embedding_matches_jax():
    quant = {"enabled": True, "quantize_embedding": True}
    jeng, teng = _gpt2(quant, from_float=True)
    jw, tw = jax.device_get(jeng.params["wte"]), teng.params["wte"]
    assert tw["__q__"].dtype == torch.int8
    np.testing.assert_array_equal(tw["__q__"].numpy(), np.asarray(jw["__q__"]))
    np.testing.assert_allclose(tw["__scale__"].numpy(),
                               np.asarray(jw["__scale__"]), rtol=2.4e-7, atol=0)
    ids = _prompt(2, 12, 512, seed=7)
    ref = np.asarray(jeng.forward(ids).astype(jnp.float32))
    out = teng.forward(ids).float().numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    want, got = _gen_both(jeng, teng, _prompt(2, 7, 512, seed=8))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="quantize_embedding"):
        deepspeed_tpu_torch.init_inference(
            GPT2Model(GPT2Config.tiny()), dtype="fp32", device="cpu",
            quant={"quantize_embedding": True})
    with pytest.raises(ValueError, match="quantize_embedding"):
        deepspeed_tpu_torch.init_inference(
            LlamaModel(LlamaConfig.tiny()), dtype="fp32", device="cpu",
            quant={"enabled": True, "quantize_embedding": True})


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (40, 1.0), (0, 0.1),
                                         (0, 0.5), (0, 0.9), (20, 0.9),
                                         (3, 0.999)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = (np.random.RandomState(0).randn(4, 64) * 3.0).astype(np.float32)
    ref = np.asarray(jax_filter_logits(jnp.asarray(logits), top_k=top_k,
                                       top_p=top_p))
    out = filter_logits(torch.from_numpy(logits), top_k=top_k,
                        top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    kept = np.isfinite(ref)
    np.testing.assert_array_equal(out[kept], logits[kept])


def test_sampled_generate_repeats_with_its_seed():
    _, teng = _gpt2()
    prompt = np.zeros((2, 4), np.int32)
    kw = dict(max_new_tokens=8, do_sample=True, top_k=50, top_p=0.9,
              temperature=0.8)
    a = teng.generate(prompt, seed=7, **kw)
    b = teng.generate(prompt, seed=7, **kw)
    assert torch.equal(a, b)
    c = teng.generate(prompt, **kw)         # the engine's own generator
    d = teng.generate(prompt, **kw)         # ... advanced by c
    assert not torch.equal(c, d)
    assert ((a >= 0) & (a < 512)).all()


def test_sampled_frequencies_follow_the_filtered_softmax():
    logits = torch.from_numpy(
        (np.random.RandomState(1).randn(1, 32) * 2.0).astype(np.float32))
    temp, top_k, top_p, n = 0.8, 12, 0.95, 20000
    pick = InferenceEngine._make_pick(True, top_k, top_p)
    gen = torch.Generator().manual_seed(0)
    draws = pick(logits.expand(n, -1), temp, gen).numpy()
    probs = torch.softmax(filter_logits(logits / temp, top_k=top_k,
                                        top_p=top_p), -1)[0].numpy()
    support = probs > 0
    assert set(np.unique(draws)) <= set(np.where(support)[0])
    observed = np.bincount(draws, minlength=32)[support]
    kept = probs[support].astype(np.float64)
    expected = kept / kept.sum() * n
    assert expected.min() >= 5
    assert stats.chisquare(observed, expected).pvalue > 1e-3


def test_guards_raise_the_reference_errors():
    jeng, teng = _gpt2()
    groups.reset()
    cases = [
        (dict(max_new_tokens=0), ValueError),
        (dict(max_new_tokens=4, top_k=10_000), ValueError),
        (dict(max_new_tokens=4, do_sample=True, top_p=0.0), ValueError),
        (dict(max_new_tokens=4, do_sample=True, top_p=1.5), ValueError),
        (dict(max_new_tokens=125), RuntimeError),     # > max_seq_len 128
    ]
    prompt = np.zeros((1, 4), np.int32)
    for kw, err in cases:
        with pytest.raises(err):
            jeng.generate(prompt, **kw)
        with pytest.raises(err):
            teng.generate(prompt, **kw)
    for key, kw, err in [("max_out_tokens", dict(max_new_tokens=10),
                          RuntimeError),
                         ("min_tokens", dict(max_new_tokens=2), RuntimeError)]:
        val = 12 if key == "max_out_tokens" else 3
        groups.reset()
        j = deepspeed_tpu.init_inference(
            JGPT2Model(JGPT2Config.tiny(), compute_dtype=jnp.float32),
            dtype="fp32", **{key: val})
        t = deepspeed_tpu_torch.init_inference(
            GPT2Model(GPT2Config.tiny()), dtype="fp32", device="cpu",
            **{key: val})
        with pytest.raises(err, match="max_tokens|min_out_tokens"):
            j.generate(prompt, **kw)
        with pytest.raises(err, match="max_tokens|min_out_tokens"):
            t.generate(prompt, **kw)


@pytest.mark.parametrize("b,route", [(1, "flash_decode"), (2, "fused")])
def test_decode_steps_run_the_routed_plain_kernel(monkeypatch, b, route):
    """Batch 1 at rep 8 with a thin cache runs the plain flash-decode every
    decode step, batch 2 the plain fused step; neither CUDA launch counter
    moves on the CPU."""
    calls = {"flash_decode": 0, "fused": 0}
    flash_plain = tflash.flash_decode_plain
    fused_plain = tdecode.fused_decode_step_plain

    def spy_flash(*a, **kw):
        calls["flash_decode"] += 1
        return flash_plain(*a, **kw)

    def spy_fused(*a, **kw):
        calls["fused"] += 1
        return fused_plain(*a, **kw)

    monkeypatch.setattr(tflash, "flash_decode_plain", spy_flash)
    monkeypatch.setattr(tdecode, "fused_decode_step_plain", spy_fused)
    _, teng = _llama()
    launches = (tflash.flash_decode.launches, tdecode.fused_decode_step.launches)
    teng.generate(_prompt(b, 9, 256, seed=9), max_new_tokens=MAX_NEW)
    layers = LLAMA_REP8["num_layers"]
    assert calls[route] == layers * (MAX_NEW - 1)
    assert sum(calls.values()) == calls[route]
    assert (tflash.flash_decode.launches,
            tdecode.fused_decode_step.launches) == launches


def test_programs_reproduce_generate_and_pad_the_cache():
    _, teng = _gpt2()
    ids = _prompt(2, 8, 512, seed=10)
    ref = teng.generate(ids, max_new_tokens=6)
    prefill, decode = teng.programs(2, 8, 6)
    gen = torch.Generator().manual_seed(0)
    tok, cache = prefill(teng.params, torch.from_numpy(ids).long(), 1.0, gen)
    assert cache["k"].shape[3] % 128 == 0 and cache["index"] == 8
    toks = decode(teng.params, tok, cache, 1.0, gen)
    np.testing.assert_array_equal(toks.numpy(), ref[:, 8:].numpy())
