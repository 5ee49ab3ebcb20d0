"""Parity of the port's continuous-batching server
(deepspeed_tpu_torch/serving) with the JAX package's ``ServingEngine``.

Both engines serve the same LLaMA weights (the JAX engine's, carried over
by the weight bridge) and the same mixed-length Poisson trace from one
numpy seed, under a virtual clock, with 4 slots and one 32-token bucket.

* fp32: every request's greedy tokens are identical, and identical to the
  port's own solo run of the request (slot isolation).
* bf16 and int8 (weight-only int8 block matmuls, the JAX engine's own
  quantized weights): teacher-forced logits — both models' no-cache
  forward over prompt + the JAX engine's tokens — agree within 1e-2 of
  max |logit| (one or two bf16 ulps; measured <= 7e-3), and the served
  tokens are identical on every step up to the first one whose
  teacher-forced top-2 margin is within 2 x that tolerance (a closer call
  may round either way).
* fp32 with an EOS token and mixed priority classes: the same tokens and
  the same finish reasons per request as the JAX engine (requests that
  emit the EOS token stop there, the rest run to their length).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving import poisson_trace as jax_poisson_trace
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.inference.weights import llama_params_from_numpy
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.serving import (EngineConfigError, PromptTooLongError,
                                         Request, ServingEngine,
                                         SlotCapacityError, poisson_trace)
from deepspeed_tpu_torch.telemetry import SLOEngine, SpanTracer

SLOTS, MAX_LEN, BUCKETS = 4, 128, (32,)
LOGIT_TOL = 1e-2


class VirtualClock:
    def __init__(self, dt=0.001):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _trace(seed=0):
    kw = dict(rate=400.0, prompt_lens=[3, 11, 20, 32],
              max_new_choices=[2, 6, 9], vocab_size=512)
    return (poisson_trace(np.random.RandomState(seed), 7, **kw),
            jax_poisson_trace(np.random.RandomState(seed), 7, **kw))


def _engines(dtype):
    groups.reset()
    jeng = deepspeed_tpu.init_inference(JLlamaModel(JLlamaConfig.tiny()),
                                        dtype=dtype, max_out_tokens=MAX_LEN)
    serve_dtype = "bf16" if dtype == "int8" else dtype
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[serve_dtype]
    params = llama_params_from_numpy(jax.device_get(jeng.params), "cpu", tdt)
    teng = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig.tiny()), dtype=dtype, device="cpu",
        params=params)
    return jeng, teng


def _serve_both(jeng, teng):
    treqs, jreqs = _trace()
    jsrv = JServingEngine(jeng, num_slots=SLOTS, max_len=MAX_LEN,
                          buckets=BUCKETS, time_fn=VirtualClock(),
                          telemetry=False)
    jout = {r.rid: r.tokens for r in jsrv.run(jreqs)}
    tsrv = ServingEngine(teng, num_slots=SLOTS, max_len=MAX_LEN,
                         buckets=BUCKETS, time_fn=VirtualClock())
    tout = {r.rid: r for r in tsrv.run(treqs)}
    assert sorted(tout) == sorted(jout) == [r.rid for r in treqs]
    for r in treqs:
        assert len(tout[r.rid].tokens) == r.max_new_tokens
        assert tout[r.rid].finish_reason == "length"
    assert tsrv.decode_steps == jsrv.decode_steps
    return treqs, jout, {rid: r.tokens for rid, r in tout.items()}


def test_fp32_tokens_identical_to_jax_and_to_solo_runs():
    jeng, teng = _engines("fp32")
    treqs, jout, tout = _serve_both(jeng, teng)
    assert tout == jout
    for r in treqs[:3]:
        solo = ServingEngine(teng, num_slots=SLOTS, max_len=MAX_LEN,
                             buckets=BUCKETS, time_fn=VirtualClock())
        [res] = solo.run([Request(rid=r.rid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens)])
        assert res.tokens == tout[r.rid], f"rid {r.rid}: solo != packed"


def test_fp32_eos_and_priorities_match_jax():
    jeng, teng = _engines("fp32")
    _, jout, _ = _serve_both(jeng, teng)
    # an EOS token that some request emits mid-stream
    eos = next(toks[1] for toks in jout.values() if len(toks) > 2)

    def trace(mod):
        reqs = _trace()[0 if mod == "torch" else 1]
        for i, r in enumerate(reqs):
            r.priority = i % 3
        return reqs

    jsrv = JServingEngine(jeng, num_slots=SLOTS, max_len=MAX_LEN,
                          buckets=BUCKETS, time_fn=VirtualClock(),
                          telemetry=False, eos_token_id=eos)
    want = {r.rid: (r.tokens, r.finish_reason) for r in jsrv.run(trace("jax"))}
    tsrv = ServingEngine(teng, num_slots=SLOTS, max_len=MAX_LEN,
                         buckets=BUCKETS, time_fn=VirtualClock(),
                         eos_token_id=eos)
    got = {r.rid: (r.tokens, r.finish_reason) for r in tsrv.run(trace("torch"))}
    assert got == want
    assert "eos" in {reason for _, reason in got.values()}


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_teacher_forced_logits_and_margin_safe_tokens_match_jax(dtype):
    jeng, teng = _engines(dtype)
    treqs, jout, tout = _serve_both(jeng, teng)
    jfwd = jax.jit(jeng.module.forward_hidden)
    for r in treqs:
        seq = list(r.prompt) + jout[r.rid][:-1]
        ids = np.asarray([seq], np.int32)
        jlog = np.asarray(jeng.module.logits(
            jeng.params, jfwd(jeng.params, jnp.asarray(ids))).astype(
                jnp.float32))[0, len(r.prompt) - 1:]
        tlog = teng.forward(ids).float().numpy()[0, len(r.prompt) - 1:]
        tol = LOGIT_TOL * np.abs(jlog).max()
        assert np.abs(tlog - jlog).max() <= tol, (r.rid, dtype)
        for step, (jt, tt) in enumerate(zip(jout[r.rid], tout[r.rid])):
            top2 = np.sort(jlog[step])[-2:]
            if top2[1] - top2[0] <= 2 * tol:
                break               # a near tie: later steps may diverge
            assert tt == jt, (r.rid, step)


def test_unported_options_and_bad_requests_raise_typed_errors():
    teng = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig.tiny()), dtype="fp32", device="cpu")
    # kv_dtype needs prefix_cache: quantized KV lives in the block pool; a
    # budget must hold a bucket, and the TPOT guard needs a budget
    for kw in ({"speculative": "beam"}, {"preemption": "lru"},
               {"tpot_slo_ms": 5.0}, {"kv_dtype": "int8"},
               {"prefix_cache": True, "kv_dtype": "int4"},
               {"speculative": {"mode": "draft"}}):
        with pytest.raises(EngineConfigError):
            ServingEngine(teng, num_slots=2, max_len=64, buckets=(16,), **kw)
    # speculation, the span tracer, the SLO engine and tenants are ported
    ServingEngine(teng, num_slots=2, max_len=64, buckets=(16,),
                  speculative="ngram", tracer=SpanTracer(),
                  slo=SLOEngine(), tenants=True)
    with pytest.raises(EngineConfigError, match="smallest prefill bucket"):
        ServingEngine(teng, num_slots=2, max_len=64, buckets=(16,),
                      prefill_token_budget=8)
    ServingEngine(teng, num_slots=2, max_len=64, buckets=(16,),
                  prefill_token_budget=16, preemption="swap",
                  swap_max_bytes=1 << 20, tpot_slo_ms=5.0, slo_max_defer=2,
                  do_sample=True, temperature=0.8, top_k=8, top_p=0.9)
    srv = ServingEngine(teng, num_slots=2, max_len=64, buckets=(16,))
    with pytest.raises(PromptTooLongError):
        srv.submit(Request(rid=0, prompt=[1] * 17, max_new_tokens=1))
    with pytest.raises(SlotCapacityError):
        srv.submit(Request(rid=1, prompt=[1] * 16, max_new_tokens=49))
    with pytest.raises(EngineConfigError):
        ServingEngine(teng, num_slots=2, max_len=256)   # > max_seq_len 128


def test_decode_kernel_geometry_is_checked_per_cache():
    """On the card every decode step runs the kernel, so ServingEngine asks
    its cache whether the kernel takes it (and refuses at construction when
    not): 16-byte rows, whole GQA groups."""
    from deepspeed_tpu_torch.serving import BlockKVPool
    from deepspeed_tpu_torch.serving.kv_slots import SlotKVCache

    tiny = LlamaModel(LlamaConfig.tiny())                    # Dh 16, rep 2
    narrow = LlamaModel(LlamaConfig(vocab_size=64, max_seq_len=64,
                                    num_layers=1, hidden_size=16,
                                    num_heads=4, num_kv_heads=2,
                                    intermediate_size=32))   # Dh 4
    for model, dtype, want in ((tiny, torch.bfloat16, True),
                               (narrow, torch.float32, True),
                               (narrow, torch.bfloat16, False)):
        hq = model.config.num_heads
        slot = SlotKVCache(model, 2, 32, dtype=dtype, device="cpu")
        assert slot.decode_kernel_supports(hq) == want, (dtype, hq)
        pool = BlockKVPool(model, 2, 32, block_size=16, dtype=dtype,
                           device="cpu")
        assert pool.decode_kernel_supports(hq) == want, (dtype, hq)
    for model, want in ((tiny, True), (narrow, False)):     # 1-byte payloads
        pool = BlockKVPool(model, 2, 32, block_size=16, dtype=torch.float32,
                           kv_dtype="int8", device="cpu")
        assert pool.decode_kernel_supports(model.config.num_heads) == want
