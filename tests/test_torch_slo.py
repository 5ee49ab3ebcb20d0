"""SLO-aware serving of the port (chunked prefill, priority preemption with
host KV swap, the TPOT guard, sampling, cancel) held against the JAX
package's ``ServingEngine`` on the CPU.

Both engines serve the tiny LLaMA in fp32 with the same weights (the JAX
engine's, carried over by the weight bridge), each on a virtual clock that
advances per read, so admissions, chunks and preemptions fall alike. All
token comparisons are exact: fp32 on the CPU, the same rounding points on
both sides.

* Chunked prefill, slot- and block-paged: a prompt longer than the largest
  bucket prefills in 16-token chunks; the tokens equal the JAX chunked
  engine's and the port's own monolithic engine's; the program counts and
  per-program entries equal the JAX engine's (chunk programs included).
* Preemption round trip, slot- and block-paged, mid-decode and mid-prefill:
  tokens equal the JAX engine's and the solo runs'; ``preemptions``,
  ``decode_calls`` and the preempted intervals equal the JAX engine's; the
  swap buffer drains; nothing is built after warm-up.
* int8 and fp8 pools: a preempting run's tokens equal the JAX engine's and
  an uninterrupted run's, and a swap round trip through the programs gives
  the pool back byte for byte.
* The swap buffer's cap: declined preemptions counted as the JAX engine
  counts them; the SLO counters, per-class histograms and swap gauges in
  the telemetry registry as the JAX engine's.
* The four trace generators give the reference's requests from one seed;
  the scheduler's ``resubmit`` / ``peek`` / ``remove`` / ``free_slots`` and
  ``HostSwapBuffer``'s accounting follow the reference on scripted
  sequences.
* ``cancel`` of a queued and of a running request, both stores, as the JAX
  engine; the TPOT guard defers, then yields, as the reference's.
* Sampling: distribution only (torch's generator gives other bits than
  JAX's): the first token of 2000 identical requests, and one decode step
  of 2000 identical slots, each pass a chi-squared test against the filtered
  softmax (p > 1e-3); a sampled engine repeats with its seed. Those 4000
  draws run in one intra-op thread: each prefill is one request's forward
  at hidden 64, and with torch's default team every small op paid a
  thread barrier, which on a host loaded by six pytest workers took 264 s
  where one thread takes 40.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
from scipy import stats

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu.serving import HostSwapBuffer as JHostSwapBuffer
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving import SlotScheduler as JSlotScheduler
from deepspeed_tpu.serving import Request as JRequest
from deepspeed_tpu.serving import bimodal_trace as jbimodal_trace
from deepspeed_tpu.serving import bursty_poisson_trace as jbursty_trace
from deepspeed_tpu.serving import straggler_trace as jstraggler_trace
from deepspeed_tpu.serving import templated_trace as jtemplated_trace
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.inference.engine import filter_logits
from deepspeed_tpu_torch.inference.weights import llama_params_from_numpy
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.serving import (EngineConfigError, HostSwapBuffer,
                                         KVLifecycleError, Request,
                                         ServingEngine, SlotScheduler,
                                         SwapCapacityError, bimodal_trace,
                                         bursty_poisson_trace, straggler_trace,
                                         templated_trace)
from deepspeed_tpu_torch.serving.swap import to_device, to_host

BS = 16
VOCAB = 512


@pytest.fixture(scope="module", autouse=True)
def _module_one_intra_op_thread():
    """torch's intra-op team cut to one thread for the module (its models
    are tiny: every op is a few hundred rows at most; on a host loaded by
    parallel test workers each op's thread barrier cost more than the op),
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
                                        dtype="fp32", max_out_tokens=128)
    params = llama_params_from_numpy(jax.device_get(jeng.params), "cpu",
                                     torch.float32)
    teng = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig.tiny()), dtype="fp32", device="cpu",
        params=params)
    return jeng, teng


def _pair(engines, prefix_cache=False, num_slots=4, max_len=128,
          buckets=(16, 96), **kw):
    """A JAX and a port ServingEngine of one configuration."""
    jeng, teng = engines
    if prefix_cache:
        kw.setdefault("block_size", BS)
    kw.update(num_slots=num_slots, max_len=max_len, buckets=buckets,
              prefix_cache=prefix_cache, telemetry=False)
    return (JServingEngine(jeng, time_fn=VirtualClock(), **kw),
            ServingEngine(teng, time_fn=VirtualClock(), **kw))


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=n).tolist() for n in lens]


def _serve(srv, reqs, jax_side):
    """Serve ``reqs`` (tuples of Request fields) as the side's Requests."""
    cls = JRequest if jax_side else Request
    return {r.rid: r for r in srv.run([cls(*r) for r in reqs])}


def _both(jsrv, tsrv, reqs):
    want, got = _serve(jsrv, reqs, True), _serve(tsrv, reqs, False)
    assert {k: r.tokens for k, r in got.items()} == \
        {k: r.tokens for k, r in want.items()}
    return want, got


def _contract(jsrv, tsrv):
    assert tsrv.program_count == jsrv.program_count
    assert tsrv.program_cache_sizes() == jsrv.program_cache_sizes()
    assert set(tsrv.program_cache_sizes().values()) == {1}
    assert tsrv.recompile_count() == 0


# ----------------------------------------------------------- chunked prefill
@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["slot_paged", "block_paged"])
def test_chunked_prefill_matches_jax_and_monolithic(engines, prefix_cache):
    prompts = _prompts([70, 9, 23, 40])
    reqs = [(i, p, 8) for i, p in enumerate(prompts)]
    jmono, tmono = _pair(engines, prefix_cache)
    mono = _both(jmono, tmono, reqs)[1]
    jsrv, tsrv = _pair(engines, prefix_cache, buckets=(16,),
                       prefill_token_budget=16)
    want, got = _both(jsrv, tsrv, reqs)
    assert {k: r.tokens for k, r in got.items()} == \
        {k: r.tokens for k, r in mono.items()}
    chunks = {k: r.prefill_chunks for k, r in got.items()}
    assert chunks == {k: r.prefill_chunks for k, r in want.items()}
    assert chunks[0] == 5                     # 70 tokens in chunks of 16
    assert tsrv.prefill_chunks == jsrv.prefill_chunks
    assert tsrv.decode_steps == jsrv.decode_steps
    for k, r in got.items():                  # TTFT at the last chunk
        assert r.token_times[0] == r.first_token_time > r.admitted_time
        assert r.decode_calls == len(r.tokens) - 1
    _contract(jsrv, tsrv)
    if not prefix_cache:
        assert "chunk_prefill_16" in tsrv.program_cache_sizes()


def test_chunked_prefill_interleaves_decode(engines):
    """While a long prompt prefills one chunk an iteration, a running
    request decodes every iteration; no token before the last chunk."""
    _, srv = _pair(engines, num_slots=2, buckets=(16,),
                   prefill_token_budget=16)
    short, long_p = _prompts([9, 70])
    srv.submit(Request(0, short, 12))
    srv.warmup()
    srv.step()
    srv.step()
    before = len(srv._slots[0].result.tokens)
    srv.submit(Request(1, long_p, 2))
    srv.step()
    st0, st1 = srv._slots
    assert st1 is not None and st1.prefilling and st1.result.tokens == []
    assert len(st0.result.tokens) == before + 1
    assert {r.rid for r in srv.run([])} == {0, 1}


def test_long_prompt_needs_a_budget(engines):
    _, srv = _pair(engines, buckets=(16,))
    prompt = _prompts([40])[0]
    with pytest.raises(ValueError, match="prefill_token_budget"):
        srv.submit(Request(0, prompt, 4))
    _, chunked = _pair(engines, buckets=(16,), prefill_token_budget=16)
    chunked.submit(Request(0, prompt, 4))
    [r] = chunked.run([])
    assert len(r.tokens) == 4
    with pytest.raises(ValueError, match="slot capacity"):
        chunked.submit(Request(1, _prompts([120])[0], 30))


# ---------------------------------------------------------------- preemption
def _preempt_case(mid_prefill):
    """Two requests on one slot: a lower-class long one and a class-0 one
    arriving while the first decodes (or, chunked, still prefills)."""
    if mid_prefill:
        a, b = _prompts([70, 9], seed=7)
        return ([(0, a, 8, 0.0, 1), (1, b, 3, 0.002, 0)],
                dict(buckets=(16, 32), prefill_token_budget=16))
    a, b = _prompts([21, 9], seed=3)
    return ([(0, a, 24, 0.0, 1), (1, b, 6, 0.02, 0)],
            dict(buckets=(16, 32)))


@pytest.mark.parametrize("mid_prefill", [False, True],
                         ids=["mid_decode", "mid_prefill"])
@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["slot_paged", "block_paged"])
def test_preemption_round_trip_matches_jax_and_solo(engines, prefix_cache,
                                                    mid_prefill):
    reqs, kw = _preempt_case(mid_prefill)
    solo = {}
    for rid, prompt, new, _, _ in reqs:
        _, s = _pair(engines, prefix_cache, num_slots=1, **kw)
        [r] = s.run([Request(rid, prompt, new)])
        solo[rid] = r.tokens
    jsrv, tsrv = _pair(engines, prefix_cache, num_slots=1,
                       preemption="swap", **kw)
    want, got = _both(jsrv, tsrv, reqs)
    assert {k: r.tokens for k, r in got.items()} == solo
    fields = ("preemptions", "decode_calls", "preempted_wall",
              "decode_preempted_wall", "prefill_chunks")
    for rid in got:
        assert [getattr(got[rid], f) for f in fields] == \
            [getattr(want[rid], f) for f in fields], rid
    a, b = got[0], got[1]
    assert a.preemptions >= 1 and b.preemptions == 0
    assert tsrv.preemptions == a.preemptions == jsrv.preemptions
    assert a.preempted_wall > 0 and a.queue_wait >= a.preempted_wall
    if mid_prefill:       # parked before its first token: not in its TPOT
        assert a.decode_preempted_wall == 0
    else:
        assert a.decode_preempted_wall == a.preempted_wall
    assert (tsrv.swapped_blocks_out, tsrv.swapped_blocks_in) == \
        (jsrv.swapped_blocks_out, jsrv.swapped_blocks_in)
    assert tsrv.swapped_blocks_out >= 1
    assert len(tsrv.swap) == 0 and tsrv.swap.bytes_stored == 0
    assert tsrv.swap.peak_bytes > 0
    _contract(jsrv, tsrv)
    assert {"swap_out", "swap_in"} <= set(tsrv.program_cache_sizes())


def test_no_preemption_within_a_class_or_past_aging(engines):
    """Same-class pressure never preempts, nor does a candidate that the
    running request has aged past; a fresh lower-class victim is
    preempted under mild aging. As the JAX engine, on each case."""
    a, b = _prompts([9, 9], seed=5)
    cases = [([(0, a, 10, 0.0, 0), (1, b, 4, 0.01, 0)], {}, 0),
             ([(0, a, 20, 0.0, 3), (1, b, 4, 0.05, 0)],
              dict(priority_aging_sec=0.01), 0),
             ([(0, a, 20, 0.0, 3), (1, b, 4, 0.02, 0)],
              dict(priority_aging_sec=10.0), 1)]
    for reqs, kw, n in cases:
        jsrv, tsrv = _pair(engines, num_slots=1, buckets=(16, 32),
                           preemption="swap", **kw)
        want, got = _both(jsrv, tsrv, reqs)
        assert tsrv.preemptions == jsrv.preemptions
        assert (tsrv.preemptions >= 1) == bool(n)
        if not n:
            assert got[1].admitted_time >= got[0].finish_time


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_swap_round_trip_is_byte_identical(engines, kv_dtype):
    rng = np.random.RandomState(6)
    reqs = [(rid, rng.randint(2, VOCAB, size=n).tolist(), new, at, pri)
            for rid, n, pri, at, new in ((0, 40, 2, 0.0, 20),
                                         (1, 40, 2, 0.0, 20),
                                         (2, 24, 0, 0.01, 6),
                                         (3, 24, 0, 0.01, 6))]
    # a tight pool on 2 slots: the class-0 arrivals preempt
    jsrv, tsrv = _pair(engines, True, num_slots=2, num_blocks=14,
                       buckets=(16, 64), preemption="swap", kv_dtype=kv_dtype)
    got = _both(jsrv, tsrv, reqs)[1]
    assert tsrv.preemptions > 0 and tsrv.swapped_blocks_in > 0
    assert tsrv.preemptions == jsrv.preemptions
    _contract(jsrv, tsrv)
    # an uninterrupted run of a roomy pool gives the same tokens
    _, control = _pair(engines, True, kv_dtype=kv_dtype, buckets=(16, 64))
    ctrl = _serve(control, [r[:3] for r in reqs], False)
    assert {k: r.tokens for k, r in ctrl.items()} == \
        {k: r.tokens for k, r in got.items()}
    # one explicit round trip through the programs: every block named,
    # the pool's bytes back unchanged
    pool = tsrv.cache
    out_fn, in_fn = pool.swap_programs(tsrv.engine)
    table = torch.arange(pool.max_blocks_per_slot, dtype=torch.int32)
    before = {k: t.clone() for k, t in pool.k.items()}
    k_blk, v_blk = out_fn(pool.k, pool.v, table)
    host_k, host_v = to_host(k_blk), to_host(v_blk)
    for leaf in list(pool.k.values()) + list(pool.v.values()):
        leaf[:, :pool.max_blocks_per_slot].view(torch.uint8).zero_()
    in_fn(pool.k, pool.v, to_device(host_k, "cpu"), to_device(host_v, "cpu"),
          table, pool.lengths, 0, int(pool.lengths[0]))
    for name, t in before.items():
        assert torch.equal(pool.k[name].view(torch.uint8),
                           t.view(torch.uint8)), name
    assert pool.k["q"].dtype == {"int8": torch.int8,
                                 "fp8": torch.float8_e4m3fn}[kv_dtype]
    assert host_k["q"].dtype == pool.k["q"].dtype


def test_swap_cap_declines_preemptions_as_jax(engines):
    reqs, kw = _preempt_case(False)
    jsrv, tsrv = _pair(engines, num_slots=1, preemption="swap",
                       swap_max_bytes=1024, **kw)
    want, got = _both(jsrv, tsrv, reqs)
    assert tsrv.preemptions == jsrv.preemptions == 0
    assert tsrv.swap_capacity_rejections == jsrv.swap_capacity_rejections > 0
    assert tsrv.swap.capacity_rejections == tsrv.swap_capacity_rejections
    assert got[1].admitted_time >= got[0].finish_time


@pytest.mark.parametrize("cap", [None, 1024], ids=["swap", "capped"])
def test_slo_telemetry_matches_jax(engines, cap):
    """The registry after a preempting chunked run (and one whose swap cap
    declines every preemption): the SLO counters, the per-class latency
    histograms' counts and the swap buffer's gauges equal the JAX
    engine's."""
    from deepspeed_tpu.telemetry import MetricsRegistry as JMetricsRegistry
    from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry

    jeng, teng = engines
    a, b = _prompts([40, 9], seed=11)
    reqs = [(0, a, 16, 0.0, 1), (1, b, 4, 0.01, 0)]
    kw = dict(num_slots=1, max_len=128, buckets=(16, 32),
              prefill_token_budget=16, preemption="swap",
              swap_max_bytes=cap)
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    _serve(JServingEngine(jeng, telemetry=jreg, time_fn=VirtualClock(), **kw),
           reqs, True)
    _serve(ServingEngine(teng, telemetry=treg, time_fn=VirtualClock(), **kw),
           reqs, False)
    want, got = jreg.snapshot(), treg.snapshot()
    for name in ("serving/prefill_chunks", "serving/preemptions",
                 "serving/swapped_blocks_out", "serving/swapped_blocks_in",
                 "serving/swap_capacity_rejections", "serving/prefills"):
        assert got["counters"].get(name) == want["counters"].get(name), name
    for name in ("serving/ttft_ms/p0", "serving/ttft_ms/p1",
                 "serving/tpot_ms/p0", "serving/tpot_ms/p1",
                 "serving/queue_wait_ms"):
        assert got["histograms"][name]["count"] == \
            want["histograms"][name]["count"], name
    for name in ("serving/swap_buffer_bytes",
                 "serving/swap_buffer_peak_bytes",
                 "serving/swap_buffer_max_bytes"):
        assert (got["gauges"].get(name) is None) == \
            (want["gauges"].get(name) is None), name
    if cap is None:
        assert got["counters"]["serving/preemptions"] >= 1
        assert got["gauges"]["serving/swap_buffer_peak_bytes"] > 0
        assert got["gauges"]["serving/swap_buffer_bytes"] == 0
    else:
        assert got["counters"]["serving/swap_capacity_rejections"] >= 1


# --------------------------------------------------------------------- cancel
@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["slot_paged", "block_paged"])
def test_cancel_queued_and_running_matches_jax(engines, prefix_cache):
    prompts = _prompts([30, 12, 20, 9], seed=9)
    out = {}
    for side, srv in zip(("jax", "port"),
                         _pair(engines, prefix_cache, num_slots=2,
                               buckets=(16, 32))):
        cls = JRequest if side == "jax" else Request
        for i, p in enumerate(prompts):
            srv.submit(cls(i, p, 10))
        srv.warmup()
        srv._run_t0 = 0.0
        done = srv.step() + srv.step()
        assert srv.cancel(3) and srv.cancel(0)     # queued, running
        assert not srv.cancel(0) and not srv.cancel(99)
        done += srv.run([])
        out[side] = {r.rid: r.tokens for r in done}
        if prefix_cache:
            assert srv.cache.free_count + srv.prefix.cached_blocks() == \
                srv.cache.num_blocks
    assert out["port"] == out["jax"]
    assert sorted(out["port"]) == [1, 2]


def test_cancel_of_a_parked_request_drops_its_kv(engines):
    reqs, kw = _preempt_case(False)
    for side, srv in zip(("jax", "port"),
                         _pair(engines, num_slots=1, preemption="swap",
                               **kw)):
        cls = JRequest if side == "jax" else Request
        srv.submit(cls(*reqs[0]))
        srv.warmup()
        srv._run_t0 = 0.0
        for _ in range(3):
            srv.step(0.0)
        srv.submit(cls(*reqs[1][:3], 0.0, 0))
        srv.step(0.0)
        assert srv.preemptions == 1 and 0 in srv.swap
        assert srv.cancel(0)
        assert len(srv.swap) == 0 and srv.swap.bytes_stored == 0
        assert srv.swap.total_swaps_in == 0
        assert [r.rid for r in srv.run([])] == [1]


# ------------------------------------------------------------------ TPOT guard
def test_tpot_guard_defers_then_yields(engines):
    _, srv = _pair(engines, num_slots=2, buckets=(16,),
                   prefill_token_budget=16, tpot_slo_ms=5.0, slo_max_defer=3)
    srv.warmup()
    srv.submit(Request(0, _prompts([9])[0], 30))
    srv.step()
    assert srv._slots[0] is not None and not srv._slots[0].prefilling
    srv._decode_gap_ema = 0.1                  # 100 ms over a 5 ms budget
    now = srv._time()
    assert srv._iteration_prefill_budget(now) == 16   # nothing to defer
    assert srv.slo_deferred_steps == 0
    srv.submit(Request(1, _prompts([40], seed=2)[0], 4))
    assert [srv._iteration_prefill_budget(now) for _ in range(4)] == \
        [0, 0, 0, 16]
    assert srv.slo_deferred_steps == 3
    srv._decode_gap_ema = 0.001
    assert srv._iteration_prefill_budget(now) == 16
    srv.run([])
    with pytest.raises(EngineConfigError, match="tpot_slo_ms"):
        ServingEngine(engines[1], num_slots=2, max_len=128, buckets=(16,),
                      tpot_slo_ms=5.0)


# ---------------------------------------------------- traces and scheduling
def _fields(reqs):
    return [(r.rid, list(r.prompt), r.max_new_tokens, r.arrival_time,
             r.priority) for r in reqs]


@pytest.mark.parametrize("name", ["templated", "bursty", "bimodal",
                                  "straggler"])
def test_trace_generators_match_the_reference(name):
    kw = {"templated": dict(rate=50.0, pattern_len=6, repeats=4,
                            max_new_tokens=8, vocab_size=64),
          "bursty": dict(burst_size=4, burst_rate=10.0, prompt_lens=(4, 8),
                         max_new_choices=(2, 4), vocab_size=64,
                         priorities=(0, 2)),
          "bimodal": dict(rate=100.0, short_lens=(4, 8), long_lens=(64,),
                          long_frac=0.3, short_new=(4,), long_new=(2,),
                          vocab_size=64),
          "straggler": dict(rate=100.0, prompt_lens=(4,),
                            max_new_choices=(2,), straggler_every=4,
                            straggler_prompt_len=48, straggler_max_new=8,
                            vocab_size=64)}[name]
    ours, ref = {"templated": (templated_trace, jtemplated_trace),
                 "bursty": (bursty_poisson_trace, jbursty_trace),
                 "bimodal": (bimodal_trace, jbimodal_trace),
                 "straggler": (straggler_trace, jstraggler_trace)}[name]
    got = ours(np.random.RandomState(3), 20, start_rid=5, **kw)
    assert _fields(got) == _fields(ref(np.random.RandomState(3), 20,
                                       start_rid=5, **kw))
    assert len(got) == 20 and [r.rid for r in got] == list(range(5, 25))


def test_scheduler_scripts_match_the_reference():
    """Scripted submit / admit / release / resubmit / remove / peek
    sequences (equal-arrival bursts, classes, aging) give the reference's
    answers step by step."""
    def script(sched_cls, req_cls):
        log = []
        s = sched_cls(2, aging_sec=1.0)
        reqs = {i: req_cls(rid=i, prompt=[1], max_new_tokens=1,
                           arrival_time=t, priority=p)
                for i, (t, p) in enumerate([(0.0, 1), (0.0, 1), (0.0, 0),
                                            (0.5, 2), (5.0, 0), (0.1, 1)])}
        for i in range(6):
            s.submit(reqs[i])
        log.append((s.waiting, s.free_slots, s.peek(0.0).rid,
                    s.peek(3.0).rid, s.next_arrival()))
        pairs = s.admit(now=1.0)
        log.append([(r.rid, slot) for r, slot in pairs])
        log.append((s.free_slots, s.waiting))
        for r, slot in reversed(pairs):         # preempt both, LIFO
            s.release(slot)
            s.resubmit(r)
        log.append((s.peek(1.0).rid, s.free_slots))
        log.append((s.remove(1), s.remove(1), s.remove(42)))
        s.resubmit(req_cls(rid=9, prompt=[1], max_new_tokens=1,
                           arrival_time=0.05, priority=1))
        order = []
        while s.waiting:
            got = s.admit(now=6.0, limit=1)
            if not got:
                break
            (r, slot), = got
            order.append(r.rid)
            s.release(slot)
        log.append(order)
        log.append((s.admissions_per_slot, s.peak_queue_depth))
        return log

    assert script(SlotScheduler, Request) == script(JSlotScheduler, JRequest)


def test_host_swap_buffer_accounting_and_cap():
    buf, ref = HostSwapBuffer(), JHostSwapBuffer()
    k = {"q": torch.zeros((2, 3, 4), dtype=torch.float8_e4m3fn),
         "s": torch.zeros((2, 3), dtype=torch.bfloat16)}
    v = torch.zeros((2, 3, 4), dtype=torch.bfloat16)
    nbytes = 24 + 12 + 48
    buf.put(7, k, v)
    ref.put(7, {"q": np.zeros((2, 3, 4), np.uint8),
                "s": np.zeros((2, 3), np.float16)},
            np.zeros((2, 3, 4), np.float16))
    assert buf.bytes_stored == ref.bytes_stored == nbytes == buf.peak_bytes
    assert 7 in buf and len(buf) == 1
    with pytest.raises(KVLifecycleError, match="already swapped out"):
        buf.put(7, k, v)
    k2, v2 = buf.pop(7)
    assert k2 is k and v2 is v
    assert buf.bytes_stored == 0 and buf.peak_bytes == nbytes
    with pytest.raises(KeyError, match="no swapped-out KV"):
        buf.pop(7)
    assert buf.total_swaps_out == buf.total_swaps_in == 1
    capped = HostSwapBuffer(max_bytes=nbytes + 10)
    capped.put(1, k, v)
    with pytest.raises(SwapCapacityError, match="max_bytes"):
        capped.put(2, k, v)
    assert capped.capacity_rejections == 1 and 2 not in capped
    assert capped.discard(1) and not capped.discard(1)
    assert capped.bytes_stored == 0 and capped.total_swaps_in == 0
    with pytest.raises(EngineConfigError):
        HostSwapBuffer(max_bytes=0)


# ------------------------------------------------------------------- sampling
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=12, top_p=0.95)


def _chisquare(draws, logits):
    probs = torch.softmax(filter_logits(logits / SAMPLE["temperature"],
                                        top_k=SAMPLE["top_k"],
                                        top_p=SAMPLE["top_p"]), -1).numpy()
    support = probs > 0
    assert set(np.unique(draws)) <= set(np.where(support)[0])
    observed = np.bincount(draws, minlength=probs.size)[support]
    expected = probs[support].astype(np.float64)
    expected = expected / expected.sum() * len(draws)
    assert expected.min() >= 5
    return stats.chisquare(observed, expected).pvalue


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


def test_sampled_serving_follows_the_filtered_softmax(engines):
    with _one_intra_op_thread():
        _sampled_serving_follows_the_filtered_softmax(engines)


def _sampled_serving_follows_the_filtered_softmax(engines):
    _, teng = engines
    n = 2000
    prompt = _prompts([11], seed=4)[0]
    # the prefill's pick: the first token of n identical requests
    srv = ServingEngine(teng, num_slots=8, max_len=64, buckets=(16,),
                        time_fn=VirtualClock(), telemetry=False, **SAMPLE)
    first = np.array([r.tokens[0] for r in srv.run(
        [Request(i, prompt, 1) for i in range(n)])])
    with torch.no_grad():
        logits = teng.forward([prompt])[0, -1].float()
    assert _chisquare(first, logits) > 1e-3
    # the decode step's pick: one step of n slots holding the same row
    tok = int(np.bincount(first).argmax())
    dec = ServingEngine(teng, num_slots=n, max_len=16, buckets=(16,),
                        time_fn=VirtualClock(), telemetry=False, **SAMPLE)
    dec.warmup()
    one = ServingEngine(teng, num_slots=1, max_len=16, buckets=(16,),
                        time_fn=VirtualClock(), telemetry=False)
    one.run([Request(0, prompt, 1)])
    dec.cache.k.copy_(one.cache.k.expand_as(dec.cache.k))
    dec.cache.v.copy_(one.cache.v.expand_as(dec.cache.v))
    dec.cache.lengths.fill_(len(prompt))
    toks = torch.full((n,), tok, dtype=torch.int32)
    out = dec._decode(teng.params, *dec.cache.carry(), toks,
                      torch.ones((n,), dtype=torch.bool), dec._temp,
                      dec._next_rng())
    with torch.no_grad():
        logits = teng.forward([prompt + [tok]])[0, -1].float()
    assert _chisquare(out[3].numpy(), logits) > 1e-3
    assert torch.equal(dec.cache.lengths, torch.full((n,), len(prompt) + 1,
                                                     dtype=torch.int32))


def test_sampled_engine_repeats_with_its_seed(engines):
    _, teng = engines
    prompts = _prompts([70, 9, 23], seed=8)
    reqs = [Request(i, p, 6, priority=int(i == 0)) for i, p in
            enumerate(prompts)]
    runs = []
    for _ in range(2):
        srv = ServingEngine(teng, num_slots=2, max_len=128, buckets=(16, 32),
                            time_fn=VirtualClock(), telemetry=False,
                            prefill_token_budget=32, preemption="swap",
                            **SAMPLE)
        runs.append({r.rid: r.tokens for r in srv.run(
            [Request(r.rid, r.prompt, r.max_new_tokens, priority=r.priority)
             for r in reqs])})
        assert set(srv.program_cache_sizes().values()) == {1}
    assert runs[0] == runs[1]
    greedy = ServingEngine(teng, num_slots=2, max_len=128, buckets=(16, 32),
                           time_fn=VirtualClock(), telemetry=False,
                           prefill_token_budget=32)
    assert {r.rid: r.tokens for r in greedy.run(reqs)} != runs[0]
