"""Continuous-batching serving engine of the PyTorch port (port of the
greedy slot-paged and block-paged paths of deepspeed_tpu/serving/engine.py).

Between decode iterations the scheduler admits waiting requests into free
slots; each admission prefills its prompt in the smallest bucket that holds
it (batch 1, padded), and every iteration decodes one token for all slots at
a fixed width with a per-slot length vector. A request's tokens are
bit-identical whether it runs alone or beside other slots: every op of the
decode step is row-wise and the bucket padding sits causally after the true
last prompt position.

Two KV stores:

* slot-paged (default): each slot owns a ``max_len`` row of the persistent
  slot cache (serving/kv_slots.py).
* block-paged (``prefix_cache=True``): one pool of ``block_size``-token
  blocks addressed through per-slot block tables (serving/kv_blocks.py),
  with radix prefix sharing (serving/radix.py). Admission goes one request
  per scheduler call through the pool's ``fits`` predicate; the radix match
  runs at admit, then the copy-on-write forks, then the prefill of the
  unmatched suffix only, bucketed by suffix length. ``kv_dtype`` "int8" or
  "fp8" stores the pool quantized (serving/kv_quant.py).

The compile-once contract of the JAX engine: every serving program is
counted by operand signature (inference/programs.py), and the decode step
is captured as one CUDA graph on the card at :meth:`ServingEngine.warmup`,
held by this engine (the graph reads its KV store), and replayed every
iteration, its per-step inputs (tokens, active mask)
copied from pinned host buffers into persistent device buffers.
:attr:`ServingEngine.program_count`,
:meth:`ServingEngine.program_cache_sizes` and
:meth:`ServingEngine.recompile_count` read it, as in the reference.

``telemetry`` (True: the global registry; a registry; None/False: off)
records the reference's serving metrics: finished requests, prefills,
deadline sheds, latency / queue-wait / TTFT / TPOT histograms, and per
run the rates and the contract's gauges (``serving/compiled_programs``,
``serving/jit_cache_entries``, ``serving/recompiles``).

Options the JAX engine has and this port does not yet (speculative
decoding, preemption, chunked prefill, tracing, SLO control, tenants,
sampling in the serving programs) raise :class:`EngineConfigError`.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.programs import GraphProgram
from deepspeed_tpu_torch.serving.errors import (EmptyPromptError,
                                                EngineConfigError,
                                                EngineInvariantError,
                                                InvalidMaxNewTokensError,
                                                PromptTooLongError,
                                                SlotCapacityError)
from deepspeed_tpu_torch.serving.kv_blocks import BlockKVPool
from deepspeed_tpu_torch.serving.kv_quant import normalize_kv_dtype
from deepspeed_tpu_torch.serving.kv_slots import SlotKVCache
from deepspeed_tpu_torch.serving.radix import PrefixCache
from deepspeed_tpu_torch.serving.scheduler import (Request, RequestResult,
                                                   SlotScheduler, pick_bucket)
from deepspeed_tpu_torch.telemetry.registry import get_registry, metric_label
from deepspeed_tpu_torch.utils.logging import log_dist

_NOT_PORTED = ("speculative", "preemption", "prefill_token_budget", "tracer",
               "slo", "tenants", "do_sample")


class _SlotState:
    __slots__ = ("request", "result", "last_token")

    def __init__(self, request: Request, result: RequestResult,
                 last_token: int):
        self.request = request
        self.result = result
        self.last_token = last_token


class ServingEngine:
    """Drives an :class:`InferenceEngine`'s slot programs with an
    iteration-level scheduler.

    engine: InferenceEngine (owns params and the slot programs).
    num_slots: fixed decode batch width (the slot cache's batch dim).
    max_len: per-slot KV capacity in tokens; prompt + max_new_tokens must fit.
    buckets: ascending prefill pad lengths; oversized ones are clamped to
        max_len.
    eos_token_id: finish a request when it emits this token (kept in the
        output).
    time_fn: clock for arrivals and latency; time.monotonic by default,
        tests inject a virtual clock.
    priority_aging_sec: scheduler aging (one class per this many seconds).
    prefix_cache: the block-paged KV store with radix prefix sharing;
        ``block_size`` tokens per block, ``num_blocks`` pool blocks (default:
        every slot can hold a full ``max_len`` request, nothing shared).
    kv_dtype: None (the compute dtype), "int8" or "fp8": the block pool's
        storage (needs ``prefix_cache``).
    telemetry: True (default) records into the global registry
        (telemetry/registry.py), a registry records there, None/False
        records nothing.
    """

    def __init__(self, engine, *, num_slots: int = 8, max_len: int = 1024,
                 buckets: Sequence[int] = (128, 512, 2048),
                 eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                 time_fn: Optional[Callable[[], float]] = None,
                 telemetry=True, priority_aging_sec: Optional[float] = None,
                 prefix_cache: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None, speculative=None,
                 preemption: Optional[str] = None,
                 prefill_token_budget: Optional[int] = None, tracer=None,
                 slo=None, tenants: Optional[bool] = None,
                 kv_dtype: Optional[str] = None, do_sample: bool = False):
        requested = {"speculative": speculative not in (None, "off"),
                     "preemption": preemption, "prefill_token_budget":
                     prefill_token_budget, "tracer": tracer, "slo": slo,
                     "tenants": tenants, "do_sample": do_sample}
        for name in _NOT_PORTED:
            if requested[name]:
                what = ("sampling in the serving programs (InferenceEngine."
                        "generate samples; the slot and block programs pick "
                        "greedily)" if name == "do_sample" else
                        "greedy slot-paged and block-paged serving only")
                raise EngineConfigError(
                    f"ServingEngine option {name}={requested[name]!r} is not "
                    f"ported to the PyTorch engine yet ({what})")
        self.engine = engine
        self.telemetry = get_registry() if telemetry is True else (
            telemetry or None)
        mcfg = engine.module.config
        if max_len > mcfg.max_seq_len:
            raise EngineConfigError(
                f"serving max_len {max_len} exceeds the model's max_seq_len "
                f"{mcfg.max_seq_len} (position table size)")
        self.kv_dtype = normalize_kv_dtype(kv_dtype)
        if self.kv_dtype is not None and not prefix_cache:
            raise EngineConfigError(
                f"kv_dtype={kv_dtype!r} needs prefix_cache=True: quantized "
                "KV lives in the block-paged pool (serving/kv_quant.py); "
                "the slot-paged cache stays in the compute dtype")
        if prefix_cache:
            self.cache = BlockKVPool(engine.module, num_slots, max_len,
                                     block_size=block_size,
                                     num_blocks=num_blocks,
                                     dtype=engine.dtype,
                                     kv_dtype=self.kv_dtype,
                                     device=engine.device)
            self.prefix: Optional[PrefixCache] = PrefixCache(self.cache)
            self._copy_fn = self.cache.copy_program(engine)
        else:
            self.cache = SlotKVCache(engine.module, num_slots, max_len,
                                     dtype=engine.dtype, device=engine.device)
            self.prefix = None
            self._copy_fn = None
        if (torch.device(engine.device).type == "cuda"
                and not self.cache.decode_kernel_supports(mcfg.num_heads)):
            # the card runs every decode step through the kernel: refuse a
            # geometry it does not take here, not at the first step
            raise EngineConfigError(
                f"the decode kernel does not take {self.cache!r} with "
                f"{mcfg.num_heads} query heads (ops/decode_step.py "
                "supports / supports_block)")
        # the decode step's CUDA graphs read this engine's KV store, so
        # they are this engine's (on the inference engine's graph pool)
        self._decode = GraphProgram(
            self.cache.decode_program(engine, pad_token_id), engine.graph_pool)
        self.buckets = tuple(sorted({min(b, max_len) for b in buckets}))
        if not self.buckets:
            raise EngineConfigError(f"no prefill buckets given: {buckets}")
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.device = engine.device
        # the decode step's per-step inputs: host arrays (pinned on the
        # card) copied into persistent device buffers, the addresses the
        # step's CUDA graph reads
        pin = torch.device(self.device).type == "cuda"
        self._toks_host = torch.zeros((num_slots,), dtype=torch.int32,
                                      pin_memory=pin)
        self._active_host = torch.zeros((num_slots,), dtype=torch.bool,
                                        pin_memory=pin)
        self._toks = torch.zeros((num_slots,), dtype=torch.int32,
                                 device=self.device)
        self._active = torch.zeros((num_slots,), dtype=torch.bool,
                                   device=self.device)
        self._time = time_fn or time.monotonic
        # a wall clock advances with real time, so idle gaps sleep; injected
        # virtual clocks advance per call and must not
        self._real_clock = self._time in (time.monotonic, time.time,
                                          time.perf_counter)
        self.scheduler = SlotScheduler(num_slots, aging_sec=priority_aging_sec)
        self._slots: List[Optional[_SlotState]] = [None] * num_slots
        self._warm = False
        self._run_t0: Optional[float] = None
        self._prefill: Dict[int, Callable] = {}
        self.decode_steps = 0
        self.decode_wall = 0.0
        self.prefill_calls = 0
        self.tokens_generated = 0
        self._active_slot_iterations = 0
        # prompt tokens run through a prefill (the unmatched suffixes in
        # block-paged mode: radix-matched tokens never reach the device)
        self.prefill_tokens_computed = 0
        log_dist(f"ServingEngine: slots={num_slots} max_len={max_len} "
                 f"buckets={self.buckets} cache={self.cache!r}", ranks=[0])

    # ---------------------------------------------------------- programs
    def _prefill_fn(self, bucket: int):
        if bucket not in self._prefill:
            self._prefill[bucket] = self.cache.prefill_program(self.engine,
                                                               bucket)
        return self._prefill[bucket]

    @property
    def program_count(self) -> int:
        """Serving programs built so far: one prefill per bucket used, the
        decode step, and with the prefix cache the copy-on-write block copy
        (``len(buckets) + 1`` after warm-up, + 1 block-paged), as the
        reference counts them."""
        return len(self._prefill) + 1 + (self._copy_fn is not None)

    def program_cache_sizes(self) -> Dict[str, int]:
        """Entry count per serving program, by the reference's names: each
        must stay 1 after any trace (a second entry means an operand's
        shape or dtype varied; on the card, a second capture)."""
        out = {"decode": self._decode._cache_size()}
        for b, fn in self._prefill.items():
            out[f"prefill_{b}"] = fn._cache_size()
        if self._copy_fn is not None:
            out["block_copy"] = self._copy_fn._cache_size()
        return out

    def recompile_count(self) -> int:
        """Entries past the first across the serving programs: any value
        above 0 means a program recompiled (was captured again) after
        warm-up."""
        return sum(max(0, v - 1) for v in self.program_cache_sizes().values())

    def warmup(self) -> None:
        """Run every bucket's prefill and the decode step once on dummy
        data (block-paged: and the block copy, the garbage row onto itself),
        then reset the slot lengths. The decode call builds the CUDA
        kernels and captures the step's CUDA graph, off the served trace.
        Block-paged warm-up prefills through a sentinel table row, so its
        writes land in the garbage row."""
        if self._warm:
            return
        params = self.engine.params
        for b in self.buckets:
            ids = torch.zeros((1, b), dtype=torch.long, device=self.device)
            out = self._prefill_fn(b)(params, *self.cache.carry(), ids,
                                      *self.cache.prefill_args(0, 0, 1))
            self.cache.update(*out[:3])
        self._active.zero_()
        out = self._decode(params, *self.cache.carry(),
                           *self.cache.decode_args(), self._toks, self._active)
        self.cache.update(*out[:3])
        if self._copy_fn is not None:
            # the copy-on-write program: the garbage row onto itself
            self.cache.update_kv(*self._copy_fn(
                self.cache.k, self.cache.v, self.cache.sentinel,
                self.cache.sentinel))
        self.cache.lengths.zero_()
        self._warm = True

    # ------------------------------------------------------------- queue
    def submit(self, request: Request) -> None:
        """Queue a request, validating it up front with typed errors."""
        plen = len(request.prompt)
        if plen < 1:
            raise EmptyPromptError(f"request {request.rid}: empty prompt")
        if request.max_new_tokens < 1:
            raise InvalidMaxNewTokensError(
                f"request {request.rid}: max_new_tokens must be >= 1, "
                f"got {request.max_new_tokens}")
        if pick_bucket(plen, self.buckets) is None:
            raise PromptTooLongError(
                f"request {request.rid}: prompt length {plen} exceeds the "
                f"largest prefill bucket {self.buckets[-1]}")
        if not self.cache.capacity_for(plen, request.max_new_tokens):
            raise SlotCapacityError(
                f"request {request.rid}: prompt {plen} + max_new "
                f"{request.max_new_tokens} exceeds slot capacity "
                f"{self.max_len}")
        self.scheduler.submit(request)

    @property
    def pending(self) -> int:
        """Requests not yet finished (queued + in flight)."""
        return self.scheduler.waiting + sum(s is not None for s in self._slots)

    # --------------------------------------------------------- iteration
    def _now(self, fallback: float) -> float:
        if self._run_t0 is None:
            return fallback
        return self._time() - self._run_t0

    def _finish(self, slot: int, now: float, reason: str) -> RequestResult:
        st = self._slots[slot]
        st.result.finish_time = self._now(now)
        st.result.finish_reason = reason
        self._slots[slot] = None
        self.scheduler.release(slot)
        if self.prefix is not None:
            # insert-on-finish: the prompt's full blocks go to the radix
            # index, the rest are freed, the table row parks at the sentinel
            self.prefix.finish(slot)
        if self.telemetry is not None:
            res, reg = st.result, self.telemetry
            reg.counter("serving/finished_requests").inc()
            reg.histogram("serving/latency_ms").observe(res.latency * 1e3)
            # decode-phase iterations only: TTFT covers the prefill
            if res.decode_calls > 0:
                tpot = max(res.finish_time - res.first_token_time,
                           0.0) / res.decode_calls * 1e3
                reg.histogram("serving/tpot_ms").observe(tpot)
                reg.histogram(
                    f"serving/tpot_ms/p{metric_label(res.priority)}"
                ).observe(tpot)
        return st.result

    def _maybe_finish(self, slot: int, now: float) -> Optional[RequestResult]:
        st = self._slots[slot]
        if (self.eos_token_id is not None and st.result.tokens
                and st.result.tokens[-1] == self.eos_token_id):
            return self._finish(slot, now, "eos")
        if len(st.result.tokens) >= st.request.max_new_tokens:
            return self._finish(slot, now, "length")
        return None

    def _admit_fits(self, req: Request) -> bool:
        """The scheduler's ``fits`` hook: block-paged admission needs the
        request's unmatched blocks (prompt + max_new, minus radix-matched
        full blocks) from free + evictable pool blocks."""
        return self.prefix.fits(req.prompt,
                                len(req.prompt) + req.max_new_tokens)

    @staticmethod
    def _stream(st: _SlotState, tokens) -> None:
        cb = st.request.on_token
        if cb is not None:
            for t in tokens:
                cb(int(t))

    def _admit_one(self, slot: int, req: Request, now: float,
                   finished: List[RequestResult]) -> None:
        """Admit one request into ``slot``: shed it if its deadline passed,
        else (block-paged: match the prompt against the radix index and run
        the copy-on-write forks) prefill the prompt, or its unmatched
        suffix, in the smallest bucket that holds it, and commit the first
        token."""
        plen = len(req.prompt)
        res = RequestResult(rid=req.rid, prompt_len=plen,
                            arrival_time=req.arrival_time,
                            admitted_time=now, priority=req.priority)
        if req.deadline is not None and now > req.deadline:
            self.scheduler.release(slot)
            res.finish_time = self._now(now)
            res.finish_reason = "shed_deadline"
            finished.append(res)
            if self.telemetry is not None:
                self.telemetry.counter("serving/shed_deadline").inc()
            return
        st = _SlotState(req, res, last_token=0)
        self._slots[slot] = st
        if self.telemetry is not None:
            self.telemetry.counter("serving/prefills").inc()
            self.telemetry.histogram("serving/queue_wait_ms").observe(
                max(now - req.arrival_time, 0.0) * 1e3)
        start = 0
        if self.prefix is not None:
            start, copies = self.prefix.admit(slot, req.prompt,
                                              plen + req.max_new_tokens)
            for src, dst in copies:
                self.cache.update_kv(*self._copy_fn(
                    self.cache.k, self.cache.v, src, dst))
        n = plen - start
        bucket = pick_bucket(n, self.buckets)
        ids = np.full((1, bucket), self.pad_token_id, np.int64)
        ids[0, :n] = np.asarray(req.prompt[start:], np.int64)
        ids = torch.from_numpy(ids).to(self.device)
        out = self._prefill_fn(bucket)(self.engine.params, *self.cache.carry(),
                                       ids,
                                       *self.cache.prefill_args(slot, start, n))
        self.cache.update(*out[:3])
        tok = int(out[3])          # the token must reach the host stream
        self.prefill_calls += 1
        self.tokens_generated += 1
        self.prefill_tokens_computed += n
        res.prefill_chunks += 1
        st.last_token = tok
        res.tokens.append(tok)
        t_emit = self._now(now)
        res.first_token_time = t_emit
        res.token_times.append(t_emit)
        if self.telemetry is not None:
            ttft = max(t_emit - req.arrival_time, 0.0) * 1e3
            self.telemetry.histogram("serving/ttft_ms").observe(ttft)
            self.telemetry.histogram(
                f"serving/ttft_ms/p{metric_label(req.priority)}").observe(ttft)
        self._stream(st, [tok])
        done = self._maybe_finish(slot, now)
        if done is not None:
            finished.append(done)

    def _schedule(self, now: float, finished: List[RequestResult]) -> None:
        """Admit one request per scheduler call: each block-paged admission
        takes pool blocks that the next ``fits`` check must see."""
        fits = self._admit_fits if self.prefix is not None else None
        while True:
            pairs = self.scheduler.admit(now, fits=fits, limit=1)
            if not pairs:
                return
            (req, slot), = pairs
            self._admit_one(slot, req, now, finished)

    def step(self, now: Optional[float] = None) -> List[RequestResult]:
        """One serving iteration: admissions (with their prefills), then one
        decode step for every occupied slot. Returns requests finished."""
        if not self._warm:
            self.warmup()
        if now is None:
            now = self._time()
        finished: List[RequestResult] = []
        self._schedule(now, finished)
        active_slots = [i for i, s in enumerate(self._slots) if s is not None]
        if not active_slots:
            return finished
        return self._plain_step(now, active_slots, finished)

    def _plain_step(self, now: float, active_slots: List[int],
                    finished: List[RequestResult]) -> List[RequestResult]:
        # the previous step's read of its picks synchronized the stream, so
        # the pinned host buffers are free to write
        toks, active = self._toks_host.numpy(), self._active_host.numpy()
        toks.fill(self.pad_token_id)
        active.fill(False)
        for i in active_slots:
            toks[i] = self._slots[i].last_token
        active[active_slots] = True
        t0 = time.perf_counter()
        self._toks.copy_(self._toks_host, non_blocking=True)
        self._active.copy_(self._active_host, non_blocking=True)
        out = self._decode(self.engine.params, *self.cache.carry(),
                           *self.cache.decode_args(), self._toks,
                           self._active)
        self.cache.update(*out[:3])
        # the stream's one host read per step: the picks feed the streams
        nxt = out[3].cpu().numpy()
        self.decode_wall += time.perf_counter() - t0
        self.decode_steps += 1
        self._active_slot_iterations += len(active_slots)
        self.tokens_generated += len(active_slots)
        t_emit = self._now(now)
        for i in active_slots:
            st = self._slots[i]
            tok = int(nxt[i])
            st.result.tokens.append(tok)
            st.result.token_times.append(t_emit)
            st.result.decode_calls += 1
            st.last_token = tok
            self._stream(st, [tok])
            done = self._maybe_finish(i, now)
            if done is not None:
                finished.append(done)
        return finished

    def run(self, requests: Sequence[Request], *,
            warmup: bool = True) -> List[RequestResult]:
        """Serve a trace to completion. ``arrival_time``s are offsets from
        the moment run() starts; the engine idles (real clock: sleeps)
        until the next arrival when no slot is active."""
        for r in requests:
            self.submit(r)
        if warmup:
            self.warmup()
        t0 = self._time()
        self._run_t0 = t0
        tokens_before = self.tokens_generated
        results: List[RequestResult] = []
        stall = 0
        while self.pending:
            now = self._time() - t0
            if (not any(s is not None for s in self._slots)
                    and self.scheduler.waiting):
                nxt = self.scheduler.next_arrival()
                if nxt is not None and nxt > now:
                    if self._real_clock:
                        time.sleep(min(nxt - now, 0.05))
                    stall += 1
                    if stall > 10_000_000:
                        raise EngineInvariantError(
                            "serving clock is not advancing toward the next "
                            "arrival (non-monotonic time_fn?)")
                    continue
            stall = 0
            results.extend(self.step(now))
        if self.telemetry is not None:
            self._record_run_telemetry(len(results), self._time() - t0,
                                       self.tokens_generated - tokens_before)
        return results

    def _record_run_telemetry(self, n_finished: int, elapsed: float,
                              run_tokens: int) -> None:
        """The reference's per-run gauges: rates over this run, the queue's
        peak, the compile-once contract, batch fill and, block-paged, the
        pool and prefix-cache gauges."""
        reg = self.telemetry
        reg.gauge("serving/run_elapsed_s").set(elapsed)
        if elapsed > 0:
            reg.gauge("serving/finished_requests_per_sec").set(
                n_finished / elapsed)
            reg.gauge("serving/tokens_per_sec").set(run_tokens / elapsed)
        reg.gauge("serving/peak_queue_depth").set(
            self.scheduler.peak_queue_depth)
        reg.gauge("serving/compiled_programs").set(self.program_count)
        reg.gauge("serving/jit_cache_entries").set(
            sum(self.program_cache_sizes().values()))
        reg.gauge("serving/recompiles").set(self.recompile_count())
        if self.decode_steps:
            reg.gauge("serving/mean_batch_fill_ratio").set(
                self._active_slot_iterations
                / (self.decode_steps * self.num_slots))
        if self.prefix is not None:
            reg.gauge("serving/kv_pool_bytes").set(self.cache.hbm_bytes())
            reg.gauge("serving/kv_blocks_per_mib").set(
                self.cache.blocks_per_mib())
            reg.gauge("serving/prefix_hit_rate").set(self.prefix.hit_rate())
            reg.gauge("serving/prefix_pool_occupancy").set(
                self.cache.occupancy())
            reg.gauge("serving/prefix_cached_blocks").set(
                self.prefix.cached_blocks())
