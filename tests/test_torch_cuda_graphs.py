"""The compile-once contract on the card: the port's decode programs
replayed from their CUDA graphs (deepspeed_tpu_torch/inference/programs.py).

Marked ``cuda``: each test skips (in its fixture) where no CUDA device is
present. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

* The slot decode step (bf16 and int8 block weights), the block decode
  step over bf16, int8 and fp8 pools, and generate's token step (batch 1 on
  flash-decode, batch 2 on the fused step, greedy, with EOS and sampled)
  give tokens bit-identical to the same programs' eager closures, with the
  same launch counts, and each program is captured once.
* A persistent operand (the slot lengths) that moved raises.
* Two sampled generates from the engine's generator draw differently; a
  seed repeats.
* An eager decode step under ``torch.cuda.set_sync_debug_mode("error")``
  reads nothing back to the host.
* Serving engines with the same shapes on one inference engine each
  capture their own decode graph and serve alike.
* The call that captures a graph runs its step once, not twice.
* A capture after every graph of the engine's pool was freed gets a new
  pool (PyTorch refuses to capture into a pool no live graph holds).
* Chunked prefill with priority preemption and host swap, slot-paged and
  over bf16, int8 and fp8 pools: replayed tokens equal the eager closure's,
  every request's tokens its solo run's on an engine of the same shapes,
  the swap buffer drains, and the chunk and swap programs keep one entry;
  a swap round trip moves a pool's bytes out and back unchanged; a sampled
  engine replays the eager draws and repeats with its seed.
* Speculative decoding: for each k-bucket (2, 4, 8), slot-paged and over a
  bf16 block pool, greedy and sampled, the verify graph's replay gives the
  eager closure's accepted tokens, counts, KV store and lengths bit for
  bit, and a second replay from the same state repeats; the draft model's
  graph (a TinyLlama-shaped head layout, Dh 64 at GQA rep 8) likewise, and
  a self-drafting engine serves the plain engine's tokens.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.programs import (GraphPool, GraphProgram,
                                                    Program, launch_counters)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.serving import (Request, ServingEngine,
                                         poisson_trace, shared_prefix_trace)
from deepspeed_tpu_torch.serving.speculative import verify_to_host
from deepspeed_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.cuda

# Dh 128 routes every kernel; 16 / 2 heads is GQA rep 8 (flash-decode at
# batch 1 over a thin cache)
SERVE_CFG = dict(vocab_size=512, max_seq_len=256, num_layers=2,
                 hidden_size=256, num_heads=2, num_kv_heads=2,
                 intermediate_size=512)
GEN_CFG = dict(vocab_size=1024, max_seq_len=512, num_layers=2,
               hidden_size=2048, num_heads=16, num_kv_heads=2,
               intermediate_size=1024)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counts():
    return {f.__name__: f.launches for f in launch_counters()}


def _reset():
    for f in launch_counters():
        f.launches = 0


def _serve(eng, reqs, eager: bool, **kw):
    """Serve ``reqs``; with ``eager`` through the decode program's eager
    closure. Returns the tokens by rid, the launch counts and the engine."""
    srv = ServingEngine(eng, num_slots=4, max_len=256, buckets=(32, 64),
                        telemetry=False, **kw)
    if eager:
        srv._decode = srv._decode.eager
    srv.warmup()
    _reset()
    out = {r.rid: r.tokens for r in srv.run(
        [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs],
        warmup=False)}
    torch.cuda.synchronize()
    return out, _counts(), srv


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_slot_decode_replay_matches_eager(cuda, dtype):
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**SERVE_CFG)),
                                             dtype=dtype, seed=3)
    reqs = poisson_trace(np.random.RandomState(5), 6, rate=1e3,
                         prompt_lens=[5, 20, 60], max_new_choices=[6, 12],
                         vocab_size=512)
    graph, n_graph, srv = _serve(eng, reqs, eager=False)
    eager, n_eager, _ = _serve(eng, reqs, eager=True)
    assert graph == eager
    assert n_graph == n_eager and n_graph["fused_decode_step"] > 0
    assert (n_graph["int8_matmul_dma"] > 0) == (dtype == "int8")
    assert srv._decode.captures == 1
    assert set(srv.program_cache_sizes().values()) == {1}
    assert srv.recompile_count() == 0


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_block_decode_replay_matches_eager(cuda, kv):
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**SERVE_CFG)),
                                             dtype="bf16", seed=3)
    reqs = shared_prefix_trace(np.random.RandomState(11), 8, rate=1e3,
                               prefix_len=41, suffix_lens=(3, 9, 20),
                               max_new_tokens=8, vocab_size=512)
    kw = dict(prefix_cache=True, block_size=16, kv_dtype=kv)
    graph, n_graph, srv = _serve(eng, reqs, eager=False, **kw)
    eager, n_eager, _ = _serve(eng, reqs, eager=True, **kw)
    assert graph == eager
    assert n_graph == n_eager and n_graph["fused_block_decode_step"] > 0
    assert srv.prefix.blocks_cowed > 0
    assert set(srv.program_cache_sizes().values()) == {1}
    assert srv.recompile_count() == 0


def test_moved_persistent_operand_raises(cuda):
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**SERVE_CFG)),
                                             dtype="bf16", seed=3)
    srv = ServingEngine(eng, num_slots=4, max_len=256, buckets=(32,),
                        telemetry=False)
    srv.warmup()
    srv.cache.lengths = srv.cache.lengths.clone()
    srv.submit(Request(0, [1, 2, 3], 4))
    with pytest.raises(RuntimeError, match="persistent operand"):
        srv.step()


def _generate_both(eng, prompt, max_new, **kw):
    """generate() replayed, then through the token step's eager closure;
    the tokens and launch counts of each."""
    b, t = prompt.shape
    key = (b, -(-(t + max_new) // 128) * 128, kw.get("do_sample", False),
           kw.get("top_k", 0), float(kw.get("top_p", 1.0)))
    out = {}
    for mode in ("graph", "eager"):
        state = eng._decode_state(*key) if mode == "eager" else None
        if state is not None:
            step = state.step
            state.step = step.eager
        _reset()
        toks = eng.generate(prompt, max_new_tokens=max_new, **kw)
        out[mode] = (toks, _counts())
        if state is not None:
            state.step = step
    return out


@pytest.mark.parametrize("b,route", [(1, "flash_decode"), (2, "fused_decode_step")])
def test_generate_replay_matches_eager(cuda, b, route):
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**GEN_CFG)),
                                             dtype="bf16", seed=3)
    prompt = np.random.RandomState(17).randint(0, 1024, size=(b, 40))
    runs = _generate_both(eng, prompt, 12)
    assert torch.equal(runs["graph"][0], runs["eager"][0])
    assert runs["graph"][1] == runs["eager"][1]
    assert runs["graph"][1][route] == 2 * 11
    eos = int(runs["graph"][0][0, 40 + 3])
    runs = _generate_both(eng, prompt, 12, eos_token_id=eos, pad_token_id=0)
    assert torch.equal(runs["graph"][0], runs["eager"][0])
    assert set(eng.jit_cache_sizes().values()) == {1}


def test_sampled_replays_draw_differently(cuda):
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**GEN_CFG)),
                                             dtype="bf16", seed=3)
    prompt = np.random.RandomState(17).randint(0, 1024, size=(2, 40))
    kw = dict(max_new_tokens=16, do_sample=True, temperature=2.0)
    a = eng.generate(prompt, **kw)
    b = eng.generate(prompt, **kw)
    assert not torch.equal(a[:, 41:], b[:, 41:]), "replays drew the same bits"
    runs = _generate_both(eng, prompt, 16, do_sample=True, temperature=2.0,
                          top_k=50, seed=7)
    assert torch.equal(runs["graph"][0], runs["eager"][0])
    assert torch.equal(eng.generate(prompt, **kw, top_k=50, seed=7),
                       runs["graph"][0])
    assert set(eng.jit_cache_sizes().values()) == {1}


def test_gpt2_generate_replay_matches_eager(cuda):
    cfg = GPT2Config(vocab_size=2048, max_seq_len=256, num_layers=2,
                     hidden_size=256, num_heads=4)
    eng = deepspeed_tpu_torch.init_inference(GPT2Model(cfg), dtype="bf16",
                                             seed=4)
    prompt = np.random.RandomState(3).randint(0, 2048, size=(2, 30))
    runs = _generate_both(eng, prompt, 12)
    assert torch.equal(runs["graph"][0], runs["eager"][0])
    assert runs["graph"][1]["fused_decode_step"] == 2 * 11


def test_eager_decode_steps_read_nothing_back(cuda):
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**SERVE_CFG)),
                                             dtype="int8", seed=3)
    srv = ServingEngine(eng, num_slots=4, max_len=256, buckets=(32,),
                        telemetry=False)
    srv.warmup()
    gen = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig(**GEN_CFG)), dtype="bf16", seed=3)
    gen.generate(np.zeros((1, 8), np.int64), max_new_tokens=2)
    [state] = gen._decode_states.values()
    rng = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        srv._decode.eager(eng.params, *srv.cache.carry(), srv._toks,
                          srv._active, srv._temp, srv._next_rng())
        state.step.eager(gen.params, state.k, state.v, state.index,
                         state.tok, state.temp, rng)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["slot_paged", "block_paged"])
def test_two_serving_engines_with_one_shape_both_replay(cuda, prefix_cache):
    """Two serving engines with the same shapes on one inference engine,
    the second made after the first served and was dropped, and a third
    beside it: each captures its own graph over its own KV store, and each
    serves the trace with the eager closure's tokens."""
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**SERVE_CFG)),
                                             dtype="bf16", seed=3)
    reqs = shared_prefix_trace(np.random.RandomState(12), 6, rate=1e3,
                               prefix_len=41, suffix_lens=(3, 9, 20),
                               max_new_tokens=8, vocab_size=512)
    kw = dict(prefix_cache=True, block_size=16) if prefix_cache else {}
    eager, _, _ = _serve(eng, reqs, eager=True, **kw)
    first, _, srv = _serve(eng, reqs, eager=False, **kw)
    del srv
    second, _, srv2 = _serve(eng, reqs, eager=False, **kw)
    third, _, srv3 = _serve(eng, reqs, eager=False, **kw)
    assert first == second == third == eager
    assert srv2._decode.captures == srv3._decode.captures == 1
    assert set(eng.jit_cache_sizes().values()) == {1}


def test_first_call_runs_the_step_once(cuda):
    """The call that captures runs the step once (the set-up run is the
    real step, the capture runs nothing); replays run it once each."""
    x = torch.zeros((4,), device="cuda")

    def bump(v):
        v.add_(1)
        return v * 2

    prog = GraphProgram(Program(bump, "bump"), GraphPool())
    out = prog(x)
    torch.cuda.synchronize()
    assert prog.captures == 1
    assert x.tolist() == [1.0] * 4 and out.tolist() == [2.0] * 4
    for n in (2, 3):
        out = prog(x)
        torch.cuda.synchronize()
        assert x.tolist() == [float(n)] * 4 and out.tolist() == [2.0 * n] * 4
    assert prog.captures == 1 and prog._cache_size() == 1


def test_capture_after_the_pool_lost_its_graphs(cuda):
    import gc

    pool = GraphPool()
    x = torch.zeros((4,), device="cuda")

    def bump(v):
        v.add_(1)
        return v * 2

    first = GraphProgram(Program(bump, "bump"), pool)
    first(x)
    handle = pool.handle()
    del first
    gc.collect()
    second = GraphProgram(Program(bump, "bump"), pool)
    out = second(x)
    second(x)
    torch.cuda.synchronize()
    assert second.captures == 1 and pool.handle() != handle
    assert x.tolist() == [3.0] * 4 and out.tolist() == [4.0] * 4


# ------------------------------------------- chunked prefill and preemption
def _preempt_trace():
    """Two class-1 requests of 4-5 chunks at t = 0, then three class-0 ones
    at 0.012 s (virtual clock: a few iterations in), seeded."""
    rng = np.random.RandomState(21)
    reqs = [Request(i, rng.randint(0, 512, size=n).tolist(), 16, priority=1)
            for i, n in ((0, 150), (1, 100))]
    reqs += [Request(2 + j, rng.randint(0, 512, size=n).tolist(), 6,
                     arrival_time=0.012, priority=0)
             for j, n in enumerate((9, 30, 17))]
    return reqs


def _preempt_serve(eng, reqs, eager: bool, **kw):
    srv = ServingEngine(eng, num_slots=2, max_len=256, buckets=(32, 64),
                        prefill_token_budget=32, preemption="swap",
                        telemetry=False, time_fn=_Clock(), **kw)
    if eager:
        srv._decode = srv._decode.eager
    out = {r.rid: r.tokens for r in srv.run(
        [Request(r.rid, r.prompt, r.max_new_tokens,
                 arrival_time=r.arrival_time, priority=r.priority)
         for r in reqs])}
    torch.cuda.synchronize()
    return out, srv


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


@pytest.mark.parametrize("kv", ["slot", None, "int8", "fp8"])
def test_preempted_chunked_serving_replays_and_matches_solo(cuda, kv):
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**SERVE_CFG)),
                                             dtype="bf16", seed=3)
    kw = {} if kv == "slot" else dict(prefix_cache=True, block_size=16,
                                      num_blocks=24, kv_dtype=kv)
    reqs = _preempt_trace()
    graph, srv = _preempt_serve(eng, reqs, eager=False, **kw)
    eager, _ = _preempt_serve(eng, reqs, eager=True, **kw)
    assert graph == eager
    assert srv.preemptions >= 1 and srv.swapped_blocks_in >= 1
    assert len(srv.swap) == 0 and srv.swap.bytes_stored == 0
    sizes = srv.program_cache_sizes()
    assert {"swap_out", "swap_in"} <= set(sizes) and set(sizes.values()) == {1}
    assert srv._decode.captures == 1
    solo = ServingEngine(eng, num_slots=2, max_len=256, buckets=(32, 64),
                         prefill_token_budget=32, preemption="swap",
                         telemetry=False, **kw)
    for r in reqs:
        [res] = solo.run([Request(r.rid, r.prompt, r.max_new_tokens)])
        assert res.tokens == graph[r.rid], r.rid


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_block_swap_round_trip_on_the_card(cuda, kv):
    from deepspeed_tpu_torch.serving.swap import to_device, to_host

    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**SERVE_CFG)),
                                             dtype="bf16", seed=3)
    srv = ServingEngine(eng, num_slots=2, max_len=256, buckets=(32, 64),
                        prefix_cache=True, block_size=16, kv_dtype=kv,
                        telemetry=False)
    srv.run([Request(0, list(range(1, 40)), 8)])
    pool = srv.cache
    out_fn, in_fn = pool.swap_programs(eng)
    table = torch.arange(pool.max_blocks_per_slot, dtype=torch.int32,
                         device=cuda)
    leaves = lambda p: list(p.values()) if isinstance(p, dict) else [p]
    before = [t.clone() for t in leaves(pool.k) + leaves(pool.v)]
    k_blk, v_blk = out_fn(pool.k, pool.v, table)
    host_k, host_v = to_host(k_blk), to_host(v_blk)
    assert all(t.is_pinned() for t in leaves(host_k))
    for t in leaves(pool.k) + leaves(pool.v):
        t[:, :pool.max_blocks_per_slot].view(torch.uint8).zero_()
    in_fn(pool.k, pool.v, to_device(host_k, cuda), to_device(host_v, cuda),
          table, pool.lengths, 0, 0)
    torch.cuda.synchronize()
    for a, b in zip(leaves(pool.k) + leaves(pool.v), before):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_sampled_serving_replays_the_eager_draws(cuda):
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**SERVE_CFG)),
                                             dtype="bf16", seed=3)
    reqs = _preempt_trace()
    sample = dict(do_sample=True, temperature=0.8, top_p=0.9)
    first, srv = _preempt_serve(eng, reqs, eager=False, **sample)
    again, _ = _preempt_serve(eng, reqs, eager=False, **sample)
    eager, _ = _preempt_serve(eng, reqs, eager=True, **sample)
    greedy, _ = _preempt_serve(eng, reqs, eager=False)
    assert first == again == eager != greedy
    assert srv._decode.captures == 1
    assert set(srv.program_cache_sizes().values()) == {1}


# ---------------------------------------------------------- speculation
SPEC_K = (2, 4, 8)
# the draft model: TinyLlama-1.1B's head layout (Dh 64, GQA rep 8) narrowed
DRAFT_CFG = dict(vocab_size=512, max_seq_len=256, num_layers=2,
                 hidden_size=512, num_heads=8, num_kv_heads=1,
                 intermediate_size=1024)


def _spec_server(eng, prefix_cache: bool, **kw):
    """A speculative engine with four live slots, each past its prefill."""
    store = dict(prefix_cache=True, block_size=16) if prefix_cache else {}
    srv = ServingEngine(eng, num_slots=4, max_len=256, buckets=(32, 64),
                        telemetry=False, speculative=dict(
                            mode="ngram", k_buckets=SPEC_K), **store, **kw)
    srv.warmup()
    rng = np.random.RandomState(9)
    for rid, n in enumerate((5, 17, 30, 60)):
        srv.submit(Request(rid, rng.randint(0, 512, size=n).tolist(), 64))
    srv._schedule(0.0, [])
    assert all(st is not None and not st.prefilling for st in srv._slots)
    return srv


def _store(srv):
    return (tree_leaves(srv.cache.k) + tree_leaves(srv.cache.v)
            + [srv.cache.lengths])


def _state(srv):
    return [x.clone() for x in _store(srv)]


def _restore(srv, saved):
    for x, y in zip(_store(srv), saved):
        x.copy_(y)


def _fill_verify(srv, kb, seed):
    rng = np.random.RandomState(seed)
    tokens = srv._verify_tokens[kb][0].numpy()
    tokens[:] = rng.randint(0, 512, size=tokens.shape)
    srv._draft_len_host.numpy()[:] = [kb, kb - 1, 1, 0]
    srv._active_host.numpy()[:] = [True, True, True, False]


def check_verify_replay(srv, kb, gen=None):
    """The verify graph of bucket ``kb`` replayed from one state twice and
    its eager closure from the same state: the same accepted tokens, counts,
    KV store and lengths, bit for bit."""
    _fill_verify(srv, kb, kb)
    saved = _state(srv)
    runs = []
    for eager in (False, False, True):
        _restore(srv, saved)
        if gen is not None:
            gen.manual_seed(11)
        fn = srv._verify_fn(kb)
        if eager:
            srv._verify[kb] = fn.eager
        try:
            out = srv._verify_call(kb, gen)
        finally:
            srv._verify[kb] = fn
        toks, n = verify_to_host(out[3])
        runs.append((toks, n, _state(srv)))
    for toks, n, state in runs[1:]:
        np.testing.assert_array_equal(toks, runs[0][0])
        np.testing.assert_array_equal(n, runs[0][1])
        assert all(torch.equal(a, b) for a, b in zip(state, runs[0][2]))
    assert runs[0][1][3] == 0 and (runs[0][1][:3] >= 1).all()
    assert srv._verify[kb].captures == 1
    return runs[0]


@pytest.mark.parametrize("do_sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["slot_paged", "block_paged"])
def test_verify_graph_replay_matches_eager(cuda, prefix_cache, do_sample):
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**SERVE_CFG)),
                                             dtype="bf16", seed=3)
    kw = dict(do_sample=True, temperature=0.8, top_p=0.9) if do_sample else {}
    srv = _spec_server(eng, prefix_cache, **kw)
    _reset()
    for kb in SPEC_K:
        check_verify_replay(srv, kb, srv._rng)
    n = _counts()
    # the verify block runs no decode kernel (it is a multi-token step)
    assert n["fused_decode_step"] == n["fused_block_decode_step"] == 0
    assert set(srv.program_cache_sizes().values()) == {1}


def test_draft_graph_replay_matches_eager(cuda):
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**SERVE_CFG)),
                                             dtype="bf16", seed=3)
    draft = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig(**DRAFT_CFG)), dtype="bf16", seed=4)
    srv = ServingEngine(eng, num_slots=4, max_len=256, buckets=(32, 64),
                        telemetry=False, speculative=dict(
                            mode="draft", draft_engine=draft, draft_window=120,
                            k_buckets=SPEC_K))
    srv.warmup()
    drafter = srv._drafter
    rng = np.random.RandomState(2)
    hists = [rng.randint(0, 512, size=n).tolist() for n in (3, 119, 120, 200)]
    want = np.full((4,), 8)
    for kb in SPEC_K:
        _reset()
        first = drafter.propose(hists, want, kb)[0]
        again = drafter.propose(hists, want, kb)[0]
        launches = _counts()["fused_decode_step"]
        prog = drafter._programs[kb]
        drafter._programs[kb] = prog.eager
        try:
            eager = drafter.propose(hists, want, kb)[0]
        finally:
            drafter._programs[kb] = prog
        np.testing.assert_array_equal(first, again)
        np.testing.assert_array_equal(first, eager)
        # kernel B in each rollout step of each layer, replays credited
        assert launches == 2 * DRAFT_CFG["num_layers"] * (kb - 1)
        assert prog.captures == 1
    assert srv.program_cache_sizes()["draft_8"] == 1


def test_self_drafting_engine_serves_the_plain_tokens(cuda):
    """In fp32 (in bf16 the verify's einsum rounds its logits where the
    decode kernel keeps f32, so a near tie may flip)."""
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig(**SERVE_CFG)),
                                             dtype="fp32", seed=3)
    reqs = poisson_trace(np.random.RandomState(5), 6, rate=1e3,
                         prompt_lens=[5, 20, 60], max_new_choices=[6, 12],
                         vocab_size=512)
    plain, _, _ = _serve(eng, reqs, eager=False)
    spec, n, srv = _serve(eng, reqs, eager=False, speculative=dict(
        mode="draft", draft_engine=eng, draft_window=64, k_buckets=SPEC_K))
    assert spec == plain
    assert srv.spec_accepted_tokens > 0 and n["fused_decode_step"] > 0
    assert set(srv.program_cache_sizes().values()) == {1}
    assert srv.recompile_count() == 0
