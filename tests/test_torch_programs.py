"""The compile-once contract of the port (inference/programs.py) held
against the JAX package's, on the CPU.

* ``ServingEngine.program_count`` equals the JAX engine's on one seeded
  mixed-length trace, slot-paged (``len(buckets) + 1``) and block-paged
  (+ 1 for the copy-on-write block copy), and ``recompile_count()`` is 0
  on both sides after it; every ``program_cache_sizes()`` entry is 1.
* Block-paged engines over bf16, int8 and fp8 pools on one inference
  engine each keep one entry per program.
* ``InferenceEngine.jit_cache_sizes()`` has the JAX engine's keys after the
  same generate calls (two shapes, greedy and with EOS), each entry 1.
* Generate shapes that pad to one cache share one decode state, at most
  ``MAX_DECODE_STATES`` are kept, and ``programs()``' decode refuses a
  cache that a later prefill overwrote or whose state was evicted.
* Two serving engines with the same shapes on one inference engine each
  own their decode graph program over the engine's one decode program.
* The slot decode step, the block decode step and generate's token step of
  the tiny LLaMA and the tiny GPT-2 run under a guard that makes
  ``torch.Tensor.item``, ``__int__``, ``__bool__``, ``__index__`` and
  ``tolist`` raise (no host read of a device value: each step can be
  captured in a CUDA graph), with tokens equal to the unguarded run's.
* A 0-dim index tensor gives output bit-identical to the python int
  through ``apply_rotary_pos_emb``, ``cache_positions``, ``write_kv_cache``
  (clamped at the end of the cache too), the decode route and
  ``cached_attention`` (flash-decode at batch 1, the fused step at 2).
"""

import contextlib

import jax
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
from deepspeed_tpu_torch.inference.programs import GraphProgram, Program
from deepspeed_tpu_torch.inference.weights import llama_params_from_numpy
from deepspeed_tpu_torch.models.base import cache_positions
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.ops.attention import (cached_attention,
                                               decode_route, scalar_index,
                                               write_kv_cache)
from deepspeed_tpu_torch.ops.rotary import (apply_rotary_pos_emb,
                                            rope_frequencies)
from deepspeed_tpu_torch.serving import Request, ServingEngine, poisson_trace

SLOTS, MAX_LEN, BUCKETS, BS = 4, 128, (16, 64), 16
TRACE = dict(rate=400.0, prompt_lens=[3, 11, 20, 40], max_new_choices=[2, 6, 9],
             vocab_size=512)


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


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["slot_paged", "block_paged"])
def test_program_count_and_recompiles_match_jax(engines, prefix_cache):
    jeng, teng = engines
    kw = dict(num_slots=SLOTS, max_len=MAX_LEN, buckets=BUCKETS,
              time_fn=VirtualClock())
    if prefix_cache:
        kw.update(prefix_cache=True, block_size=BS)
    jsrv = JServingEngine(jeng, telemetry=False, **kw)
    tsrv = ServingEngine(teng, telemetry=False, **{**kw,
                                                   "time_fn": VirtualClock()})
    jout = {r.rid: r.tokens
            for r in jsrv.run(jax_poisson_trace(np.random.RandomState(0), 8,
                                                **TRACE))}
    tout = {r.rid: r.tokens
            for r in tsrv.run(poisson_trace(np.random.RandomState(0), 8,
                                            **TRACE))}
    assert tout == jout
    want = len(BUCKETS) + 1 + int(prefix_cache)
    assert tsrv.program_count == jsrv.program_count == want
    assert jsrv.recompile_count() == 0 and tsrv.recompile_count() == 0
    # entry counts by program: 1 for each program the trace ran (the block
    # copy runs only on a fork, which this trace has none of)
    assert tsrv.program_cache_sizes() == jsrv.program_cache_sizes()
    assert tsrv.program_cache_sizes()["decode"] == 1
    assert max(tsrv.program_cache_sizes().values()) == 1
    # the decode step is the graph program (a CUDA graph on the card), the
    # prefills and the block copy run eagerly
    assert isinstance(tsrv._decode, GraphProgram)
    assert all(type(p) is Program for p in tsrv._prefill.values())


def test_each_pool_type_has_its_own_block_programs(engines):
    """Block-paged engines over pools of different types on one inference
    engine: each has its own prefill, decode and copy programs, so none
    counts a second entry (on the card each decode step is its own graph
    over its own pool)."""
    _, teng = engines
    reqs = poisson_trace(np.random.RandomState(6), 5, **TRACE)
    for kv in (None, "int8", "fp8"):
        srv = ServingEngine(teng, num_slots=SLOTS, max_len=MAX_LEN,
                            buckets=BUCKETS, time_fn=VirtualClock(),
                            telemetry=False, prefix_cache=True,
                            block_size=BS, kv_dtype=kv)
        srv.run([Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs])
        assert set(srv.program_cache_sizes().values()) == {1}, kv
        assert srv.recompile_count() == 0


def test_jit_cache_sizes_match_jax(engines):
    jeng, teng = engines
    rng = np.random.RandomState(3)
    calls = [(rng.randint(0, 512, size=(1, 7)), dict(max_new_tokens=5)),
             (rng.randint(0, 512, size=(2, 12)), dict(max_new_tokens=9)),
             (rng.randint(0, 512, size=(2, 12)),
              dict(max_new_tokens=9, eos_token_id=17, pad_token_id=0))]
    for ids, kw in calls:
        want = np.asarray(jeng.generate(ids, **kw))
        got = teng.generate(ids, **kw).numpy()
        np.testing.assert_array_equal(got, want)
    for ids, kw in calls:                      # a second pass adds nothing
        teng.generate(ids, **kw)

    def generate_keys(sizes):           # the serving programs aside
        return {k: v for k, v in sizes.items()
                if k.startswith(("('pf'", "('dec'", "('dec_eos'"))}

    sizes = generate_keys(teng.jit_cache_sizes())
    assert len(sizes) == 5          # the EOS call shares its prefill
    assert set(sizes) == set(generate_keys(jeng.jit_cache_sizes()))
    assert set(sizes.values()) == {1}


# ------------------------------------------------------------ host reads
_GUARDED = ("item", "__int__", "__bool__", "__index__", "tolist")


@contextlib.contextmanager
def no_host_reads():
    """Make every way of reading a tensor's value on the host raise."""
    saved = {name: getattr(torch.Tensor, name) for name in _GUARDED}

    def refuse(name):
        def raise_(self, *a, **k):
            raise AssertionError(f"host read of a tensor: Tensor.{name}")
        return raise_

    try:
        for name in _GUARDED:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _guarded(fn):
    def call(*args):
        with no_host_reads():
            return fn(*args)
    return call


def _tiny_engine(model):
    return deepspeed_tpu_torch.init_inference(model, dtype="fp32",
                                              device="cpu", seed=5)


def _models():
    return [LlamaModel(LlamaConfig.tiny()), GPT2Model(GPT2Config.tiny())]


@pytest.mark.parametrize("model", _models(), ids=["llama", "gpt2"])
@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["slot_step", "block_step"])
def test_serving_decode_steps_read_nothing_on_the_host(model, prefix_cache):
    eng = _tiny_engine(model)
    reqs = poisson_trace(np.random.RandomState(1), 6, **TRACE)
    kw = dict(num_slots=SLOTS, max_len=MAX_LEN, buckets=BUCKETS,
              telemetry=False)
    if prefix_cache:
        kw.update(prefix_cache=True, block_size=BS)
    out = {}
    for guard in (False, True):
        srv = ServingEngine(eng, time_fn=VirtualClock(), **kw)
        if guard:
            srv._decode = _guarded(srv._decode)
        out[guard] = {r.rid: r.tokens for r in srv.run(
            [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs])}
        assert srv.decode_steps > 0
    assert out[True] == out[False]


@pytest.mark.parametrize("model", _models(), ids=["llama", "gpt2"])
@pytest.mark.parametrize("b", [1, 2])
def test_generate_token_step_reads_nothing_on_the_host(model, b):
    eng = _tiny_engine(model)
    ids = np.random.RandomState(2).randint(0, 512, size=(b, 9))
    want = eng.generate(ids, max_new_tokens=8)
    state = eng._decode_states[(b, 128, False, 0, 1.0)]
    step = state.step
    assert isinstance(step, GraphProgram)
    state.step = _guarded(step)
    try:
        got = eng.generate(ids, max_new_tokens=8)
    finally:
        state.step = step
    assert torch.equal(got, want)
    assert step._cache_size() == 1


# ------------------------------------------------------ generate states
def test_generate_shapes_share_a_bounded_set_of_decode_states():
    """Generate shapes that pad to one cache (prompt lengths, max_new, EOS
    or not) share one decode state, while ``jit_cache_sizes`` keeps one
    entry per reference key; a third step shape evicts the least recently
    used state, and a shape whose state went is made again."""
    eng = _tiny_engine(LlamaModel(LlamaConfig.tiny()))
    rng = np.random.RandomState(4)
    ref = {}
    for t, n, kw in ((9, 8, {}), (20, 5, {}), (9, 8, dict(eos_token_id=3))):
        ids = rng.randint(0, 512, size=(2, t))
        ref[(t, n, bool(kw))] = (ids, kw, eng.generate(ids, max_new_tokens=n,
                                                       **kw))
    assert list(eng._decode_states) == [(2, 128, False, 0, 1.0)]
    sizes = {k: v for k, v in eng.jit_cache_sizes().items()
             if k.startswith(("('pf'", "('dec'", "('dec_eos'"))}
    assert len(sizes) == 5 and set(sizes.values()) == {1}
    eng.generate(rng.randint(0, 512, size=(1, 9)), max_new_tokens=4)
    eng.generate(rng.randint(0, 512, size=(2, 9)), max_new_tokens=4,
                 do_sample=True, seed=1)
    assert len(eng._decode_states) == eng.MAX_DECODE_STATES == 2
    assert (2, 128, False, 0, 1.0) not in eng._decode_states
    for ids, kw, want in ref.values():          # the state is made again
        n = want.shape[1] - ids.shape[1]
        assert torch.equal(eng.generate(ids, max_new_tokens=n, **kw), want)
    assert set(eng.decode_captures().values()) <= {0}   # nothing on the CPU


def test_programs_decode_refuses_an_overwritten_cache():
    """``programs()``: decoding a prefill's cache twice gives its tokens
    twice; a later prefill into the same state, or the state's eviction,
    makes decoding the older cache raise instead of decoding another
    prompt's cache."""
    eng = _tiny_engine(GPT2Model(GPT2Config.tiny()))
    rng = np.random.RandomState(5)
    a, b = (torch.from_numpy(rng.randint(0, 512, size=(2, 8))) for _ in "ab")
    prefill, decode = eng.programs(2, 8, 6)
    gen = torch.Generator().manual_seed(0)
    tok_a, cache_a = prefill(eng.params, a, 1.0, gen)
    first = decode(eng.params, tok_a, cache_a, 1.0, gen)
    assert torch.equal(decode(eng.params, tok_a, cache_a, 1.0, gen), first)
    np.testing.assert_array_equal(
        first.numpy(), eng.generate(a, max_new_tokens=6)[:, 8:].numpy())
    tok_a, cache_a = prefill(eng.params, a, 1.0, gen)
    prefill_b, _ = eng.programs(2, 20, 3)            # the same state
    prefill_b(eng.params, torch.from_numpy(rng.randint(0, 512, size=(2, 20))),
              1.0, gen)
    with pytest.raises(RuntimeError, match="overwrote"):
        decode(eng.params, tok_a, cache_a, 1.0, gen)
    tok_a, cache_a = prefill(eng.params, a, 1.0, gen)
    for n in (1, 3):                                  # two other states
        eng.generate(rng.randint(0, 512, size=(n, 8)), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="evicted"):
        decode(eng.params, tok_a, cache_a, 1.0, gen)


def test_serving_engines_own_their_decode_graphs(engines):
    """Two serving engines with the same shapes on one inference engine:
    each holds its own graph program (its graphs read its own KV store)
    over the inference engine's one decode program, whose single entry
    ``jit_cache_sizes`` reads; both serve the trace alike."""
    _, teng = engines
    reqs = poisson_trace(np.random.RandomState(8), 5, **TRACE)
    srvs = [ServingEngine(teng, num_slots=SLOTS, max_len=MAX_LEN,
                          buckets=BUCKETS, time_fn=VirtualClock(),
                          telemetry=False) for _ in range(2)]
    out = [{r.rid: r.tokens for r in s.run(
        [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs])}
        for s in srvs]
    assert out[0] == out[1]
    assert srvs[0]._decode is not srvs[1]._decode
    assert srvs[0]._decode.program is srvs[1]._decode.program
    key = str(("slot_dec", SLOTS, MAX_LEN, False, 0, 1.0, 0))
    assert teng.jit_cache_sizes()[key] == 1
    assert all(s.program_cache_sizes()["decode"] == 1 for s in srvs)


# ------------------------------------------------------------ 0-dim index
def test_zero_dim_index_is_the_int_index():
    g = torch.Generator().manual_seed(0)
    cos, sin = rope_frequencies(16, 64)
    x = torch.randn((2, 3, 4, 16), generator=g)
    for i in (0, 5, 62, 70):
        d = torch.tensor(i, dtype=torch.int32)
        assert torch.equal(apply_rotary_pos_emb(x, cos, sin, i),
                           apply_rotary_pos_emb(x, cos, sin, d))
        assert torch.equal(cache_positions(i, 3), cache_positions(d, 3))
        assert scalar_index(d) and scalar_index(i)
        assert not scalar_index(torch.tensor([i, i], dtype=torch.int32))
    k_full = torch.randn((2, 2, 2, 32, 8), generator=g)
    v_full = torch.randn((2, 2, 2, 32, 8), generator=g)
    for t, i in ((1, 0), (1, 31), (3, 10), (3, 30), (4, 40)):
        k_new = torch.randn((2, t, 2, 8), generator=g)
        v_new = torch.randn((2, t, 2, 8), generator=g)
        ref = write_kv_cache(k_full.clone(), v_full.clone(), k_new, v_new, 1, i)
        dev = write_kv_cache(k_full.clone(), v_full.clone(), k_new, v_new, 1,
                             torch.tensor(i, dtype=torch.int32))
        for a, b in zip(ref, dev):
            assert torch.equal(a, b)


@pytest.mark.parametrize("b,route", [(1, "flash_decode"), (2, "fused")])
def test_zero_dim_index_takes_the_scalar_route(b, route):
    g = torch.Generator().manual_seed(1)
    hq, hkv, s, dh = 16, 2, 128, 64
    assert decode_route(b, 1, hq, hkv, s, dh, 4,
                        scalar_index(torch.tensor(5))) == route
    q = torch.randn((b, 1, hq, dh), generator=g)
    k_full = torch.randn((2, b, hkv, s, dh), generator=g)
    v_full = torch.randn((2, b, hkv, s, dh), generator=g)
    k_new = torch.randn((b, 1, hkv, dh), generator=g)
    v_new = torch.randn((b, 1, hkv, dh), generator=g)
    for i in (0, 77, 127):
        ref = cached_attention(q, k_full.clone(), v_full.clone(), k_new, v_new,
                               1, i)
        dev = cached_attention(q, k_full.clone(), v_full.clone(), k_new, v_new,
                               1, torch.tensor(i, dtype=torch.int32))
        for a, c in zip(ref, dev):
            assert torch.equal(a, c)


def test_per_slot_write_drops_past_the_allocation():
    """The per-slot ``[B]`` write (fixed shape, no boolean mask) against a
    loop of slice writes that drop what lies past the cache."""
    g = torch.Generator().manual_seed(2)
    k_full = torch.randn((1, 3, 2, 16, 4), generator=g)
    v_full = torch.randn((1, 3, 2, 16, 4), generator=g)
    k_new = torch.randn((3, 4, 2, 4), generator=g)
    v_new = torch.randn((3, 4, 2, 4), generator=g)
    idx = torch.tensor([0, 14, 16], dtype=torch.int32)
    want_k, want_v = k_full.clone(), v_full.clone()
    for r, i in enumerate(idx.tolist()):
        for j in range(4):
            if 0 <= i + j < 16:
                want_k[0, r, :, i + j] = k_new[r, j]
                want_v[0, r, :, i + j] = v_new[r, j]
    with no_host_reads():
        got = write_kv_cache(k_full, v_full, k_new, v_new, 0, idx)
    assert torch.equal(got[0], want_k) and torch.equal(got[1], want_v)
