"""Parity of the port's block-paged prefix-cache serving
(``ServingEngine(prefix_cache=True)``) with the JAX package's.

Both engines serve the tiny LLaMA with the same weights (the JAX engine's,
carried over by the weight bridge), 4 slots, 16-token blocks, buckets 16 and
64, on one shared-prefix trace from one numpy seed: 8 requests over 2
templates of 41 tokens (not a multiple of the block size, so every match
after the first forks a partial block) with 3- or 9-token suffixes. The
trace arrives at 1e4 requests/s, so every request is queued by the first
step and the admission order does not depend on how often each engine reads
its virtual clock.

* fp32: tokens identical to the JAX engine's, and the prefix counters
  (prefill tokens computed, radix hit tokens, copy-on-write forks) equal;
  the tokens also equal the port's own slot-paged engine's.
* int8 and fp8 KV in fp32: tokens identical to the JAX engine's quantized
  KV.
All exact: fp32 on the CPU, the same rounding points on both sides.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving import shared_prefix_trace as jax_shared_prefix_trace
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.inference.weights import llama_params_from_numpy
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.serving import (Request, ServingEngine,
                                         shared_prefix_trace)

SLOTS, MAX_LEN, BUCKETS, BS = 4, 128, (16, 64), 16
TRACE = dict(rate=1e4, prefix_len=41, suffix_lens=(3, 9), max_new_tokens=6,
             n_prefixes=2, vocab_size=512)


class VirtualClock:
    def __init__(self, dt=0.001):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


@pytest.fixture(scope="module")
def engines():
    groups.reset()
    jeng = deepspeed_tpu.init_inference(JLlamaModel(JLlamaConfig.tiny()),
                                        dtype="fp32", max_out_tokens=MAX_LEN)
    params = llama_params_from_numpy(jax.device_get(jeng.params), "cpu",
                                     torch.float32)
    teng = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig.tiny()), dtype="fp32", device="cpu",
        params=params)
    return jeng, teng


def _serve(eng, jax_side, **kw):
    if jax_side:
        srv = JServingEngine(eng, num_slots=SLOTS, max_len=MAX_LEN,
                             buckets=BUCKETS, time_fn=VirtualClock(),
                             telemetry=False, block_size=BS, **kw)
        reqs = jax_shared_prefix_trace(np.random.RandomState(0), 8, **TRACE)
    else:
        srv = ServingEngine(eng, num_slots=SLOTS, max_len=MAX_LEN,
                            buckets=BUCKETS, time_fn=VirtualClock(),
                            block_size=BS, **kw)
        reqs = shared_prefix_trace(np.random.RandomState(0), 8, **TRACE)
    out = {r.rid: r.tokens for r in srv.run(reqs)}
    assert sorted(out) == list(range(8))
    assert all(len(t) == TRACE["max_new_tokens"] for t in out.values())
    return srv, out


def _counters(srv):
    return (srv.prefill_tokens_computed, srv.prefix.hit_tokens,
            srv.prefix.blocks_cowed)


def test_fp32_tokens_and_prefix_counters_match_jax_and_slot_paged(engines):
    jeng, teng = engines
    jsrv, want = _serve(jeng, True, prefix_cache=True)
    tsrv, got = _serve(teng, False, prefix_cache=True)
    assert got == want
    assert _counters(tsrv) == _counters(jsrv)
    assert tsrv.prefix.blocks_cowed > 0 and tsrv.prefix.hit_tokens > 0
    slot, slot_out = _serve(teng, False)
    assert slot_out == got
    assert tsrv.prefill_tokens_computed < slot.prefill_tokens_computed


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_kv_tokens_match_jax(engines, kv_dtype):
    jeng, teng = engines
    jsrv, want = _serve(jeng, True, prefix_cache=True, kv_dtype=kv_dtype)
    tsrv, got = _serve(teng, False, prefix_cache=True, kv_dtype=kv_dtype)
    assert got == want
    assert _counters(tsrv) == _counters(jsrv)
    assert tsrv.cache.k["q"].dtype == {"int8": torch.int8,
                                       "fp8": torch.float8_e4m3fn}[kv_dtype]


def test_suffix_prefill_padding_never_reaches_a_shared_block(engines):
    """A 41-token template served once leaves two full blocks in the radix
    index. A second request over it prefills an 18-token suffix from
    position 32 in the 64-token bucket: its 46 pad positions reach past the
    prompt, into the slot's private blocks and the garbage row. The shared
    blocks stay bit-identical in every layer, and a warm rerun of the
    trace prefills far fewer tokens with the same output."""
    _, teng = engines
    srv = ServingEngine(teng, num_slots=SLOTS, max_len=MAX_LEN,
                        buckets=BUCKETS, time_fn=VirtualClock(),
                        prefix_cache=True, block_size=BS)
    rng = np.random.RandomState(1)
    template = rng.randint(0, 512, size=41).tolist()
    [first] = srv.run([Request(rid=0, prompt=template + [1, 2, 3],
                               max_new_tokens=4)])
    shared = [n.block for n in srv.prefix.root.children.values()]
    shared += [c.block for n in srv.prefix.root.children.values()
               for c in n.children.values()]
    assert len(shared) == 2
    before = [(srv.cache.k[:, b].clone(), srv.cache.v[:, b].clone())
              for b in shared]
    suffix = rng.randint(0, 512, size=9).tolist()
    [second] = srv.run([Request(rid=1, prompt=template + suffix,
                                max_new_tokens=4)])
    assert srv.prefill_tokens_computed == 44 + 18
    for b, (k, v) in zip(shared, before):
        assert torch.equal(srv.cache.k[:, b], k)
        assert torch.equal(srv.cache.v[:, b], v)
    cold = ServingEngine(teng, num_slots=SLOTS, max_len=MAX_LEN,
                         buckets=BUCKETS, time_fn=VirtualClock())
    [alone] = cold.run([Request(rid=1, prompt=template + suffix,
                                max_new_tokens=4)])
    assert second.tokens == alone.tokens
    # warm rerun of a whole trace: the templates come from the index
    srv2, cold_out = _serve(teng, False, prefix_cache=True)
    pf0 = srv2.prefill_tokens_computed
    warm = {r.rid: r.tokens for r in srv2.run(
        shared_prefix_trace(np.random.RandomState(0), 8, **TRACE))}
    assert warm == cold_out
    assert srv2.prefill_tokens_computed - pf0 <= 0.4 * pf0


def test_pool_for_one_request_serializes_admissions_in_fifo_order(engines):
    """8 pool blocks (= one slot's table): three 60 + 60-token requests need
    all 8 each, so admissions wait on blocks, not slots, in arrival order."""
    _, teng = engines
    srv = ServingEngine(teng, num_slots=SLOTS, max_len=MAX_LEN,
                        buckets=BUCKETS, time_fn=VirtualClock(),
                        prefix_cache=True, block_size=BS, num_blocks=8)
    rng = np.random.RandomState(7)
    reqs = [Request(rid=i, prompt=rng.randint(0, 512, size=60).tolist(),
                    max_new_tokens=60) for i in range(3)]
    by = {r.rid: r for r in srv.run(reqs)}
    assert sorted(by) == [0, 1, 2]
    assert by[1].admitted_time >= by[0].finish_time
    assert by[2].admitted_time >= by[1].finish_time
    assert all(len(r.tokens) == 60 for r in by.values())
