"""Continuous-batching serving engine of the PyTorch port (port of the
slot-paged and block-paged paths of deepspeed_tpu/serving/engine.py).

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

Under overload (the reference's SLO-aware scheduling):

* chunked prefill (``prefill_token_budget``): each iteration prefills at
  most that many bucket-padded prompt tokens, in chunks of the largest
  bucket the budget holds, between decode steps; prompts longer than the
  largest bucket become servable, and TTFT is stamped at the last chunk.
  Slot-paged chunks run the chunk prefill over the slot's own row,
  block-paged chunks the suffix prefill from the chunk's offset.
* priority preemption with host swap (``preemption="swap"``): an arrived
  request of a strictly better class that cannot be placed swaps the
  worst lower-class slot's KV out to a host buffer (serving/swap.py,
  capped by ``swap_max_bytes``); the request is requeued at its original
  place and swapped back in later, finishing with the tokens of an
  uninterrupted run.
* the TPOT guard (``tpot_slo_ms``, ``slo_max_defer``): while the decode
  gap's moving average exceeds the budget, prefill is deferred for at
  most ``slo_max_defer`` iterations in a row.
* sampling (``do_sample``, ``temperature``, ``top_k``, ``top_p``) in every
  serving program, from a generator seeded from the inference engine's
  ``config.seed + 1``; a sampled decode step replays from its CUDA graph
  with the generator registered there.
* :meth:`ServingEngine.cancel` withdraws a queued, preempted or running
  request.

Speculative decoding (``speculative``, serving/speculative.py): each
iteration drafts up to k tokens per decode-phase slot (prompt lookup, or a
draft model through its own inference engine), verifies them all in one
target forward and emits each slot's accepted prefix plus one token, so the
greedy tokens are the plain decode's. Verify programs are one per k-bucket
(like the prefill buckets), each captured as a CUDA graph at warm-up and
replayed, its per-step inputs (the ``[B, k+1]`` block, the draft lengths,
the active mask) copied from pinned host buffers, its accepted tokens and
counts read back in one copy; a draft model's program per k-bucket is its
drafter's graph. A step where nothing was drafted runs the plain decode
step. Slots reserve ``k_max`` lookahead rows at admission for the verify's
writes before acceptance.

Span tracing (``tracer``, a telemetry/spans.SpanTracer): each request's
queue wait, prefill chunks, decode segments, swaps and cancel, and the
engine's decode, draft and verify steps, are stamped on the host at
instants the loop already holds; an armed run issues the same device work
as a bare one.

The chunk and swap programs run eagerly (counted, not captured), like the
prefills: they write the KV store and the lengths in place, so the decode
graph's addresses never move.

``telemetry`` (True: the global registry; a registry; None/False: off)
records the reference's serving metrics: finished requests, prefills,
prefill chunks, deadline sheds, preemptions and swap traffic, latency /
queue-wait / TTFT / TPOT histograms, the prefix cache's hit, miss,
copy-on-write and eviction counters, and per run the rates and the
contract's gauges (``serving/compiled_programs``,
``serving/jit_cache_entries``, ``serving/recompiles``).

The control plane, all host work at points the loop already holds (an
armed run issues the device work of a bare one):

* ``slo`` (a telemetry/slo.SLOEngine): ``maybe_evaluate(now)`` once per
  iteration on the engine's clock, so a virtual-clock trace replays its
  alert timeline exactly;
* ``tenants`` (telemetry/tenants.TenantLedger, on by default with
  telemetry): per-tenant prompt and decode tokens, prefill computed and
  saved by the prefix cache, KV block- and byte-seconds, preemptions,
  sheds, TTFT and TPOT, by ``Request.tenant_id``;
* with a tracer, each program call's host wall (:meth:`ServingEngine.
  _prog_note`): the decode and verify walls end at the token read that
  fences them, the prefill and copy walls bracket the dispatch;
  :meth:`ServingEngine.attribution_table` joins them with each program's
  analytic FLOP and byte count (telemetry/attribution.py).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.programs import GraphProgram
from deepspeed_tpu_torch.serving.errors import (EmptyPromptError,
                                                EngineConfigError,
                                                EngineInvariantError,
                                                InvalidMaxNewTokensError,
                                                PromptTooLongError,
                                                SlotCapacityError,
                                                SwapCapacityError)
from deepspeed_tpu_torch.serving.kv_blocks import BlockKVPool
from deepspeed_tpu_torch.serving.kv_quant import (normalize_kv_dtype,
                                                  pool_payload)
from deepspeed_tpu_torch.serving.kv_slots import SlotKVCache
from deepspeed_tpu_torch.serving.radix import PrefixCache
from deepspeed_tpu_torch.serving.scheduler import (Request, RequestResult,
                                                   SlotScheduler, pick_bucket)
from deepspeed_tpu_torch.serving.speculative import (AdaptiveK,
                                                     DraftModelDrafter,
                                                     NgramDrafter,
                                                     normalize_speculative,
                                                     pick_k_bucket,
                                                     verify_to_host)
from deepspeed_tpu_torch.serving.swap import HostSwapBuffer
from deepspeed_tpu_torch.telemetry.attribution import (attribution_table,
                                                       model_cost, work_cost)
from deepspeed_tpu_torch.telemetry.registry import get_registry, metric_label
from deepspeed_tpu_torch.telemetry.tenants import TenantLedger
from deepspeed_tpu_torch.utils.logging import log_dist

# tokens-per-step histograms count small integers (1 .. k + 1): unit-wide
# buckets keep their percentiles exact
_TOKENS_PER_STEP_BUCKETS = tuple(float(x) for x in range(1, 34))


class _SlotState:
    """Host-side state of one occupied slot. The slot is in its prefill
    phase while ``prefill_pos < prefill_total`` (chunked prefill): it
    spends prefill budget, emits nothing and sits the decode steps out; its
    first token comes with the last chunk. ``order`` is the engine's
    admission sequence (chunks continue in class, then admission order)."""

    __slots__ = ("request", "result", "last_token", "prefill_pos",
                 "prefill_total", "order", "tenant")

    def __init__(self, request: Request, result: RequestResult,
                 last_token: int, prefill_pos: int, prefill_total: int,
                 order: int, tenant: str = "default"):
        self.request = request
        self.result = result
        self.last_token = last_token
        self.prefill_pos = prefill_pos
        self.prefill_total = prefill_total
        self.order = order
        # the sanitized ledger key of the request's tenant
        self.tenant = tenant

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.prefill_total


class _Preempted:
    """A swapped-out request: its slot state (reattached on resume), the
    KV length it had computed, and the engine-clock instant it left the
    slots (the preempted interval is queue wait, not decode latency)."""

    __slots__ = ("state", "length", "since")

    def __init__(self, state: _SlotState, length: int, since: float):
        self.state = state
        self.length = length
        self.since = since


class _ReqTrace:
    """The span bookkeeping of one request: its trace id, the span its
    lifecycle spans hang under (the engine's root span, or the caller's
    ``parent_span``), and its open decode-segment and swapped spans.
    ``submitted_t``: for a request that arrived with trace context, where
    its queue wait starts (the first step after its submit; the caller's
    own span covers the time before)."""

    __slots__ = ("trace_id", "root", "root_span", "decode_span",
                 "swap_span", "submitted_t")

    def __init__(self, trace_id: str, root: Optional[str], root_span=None,
                 submitted_t: Optional[float] = None):
        self.trace_id = trace_id
        self.root = root
        self.root_span = root_span
        self.decode_span = None
        self.swap_span = None
        self.submitted_t = submitted_t


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
    do_sample, temperature, top_k, top_p: token selection of every serving
        program, as ``InferenceEngine.generate``'s (greedy by default).
    time_fn: clock for arrivals and latency; time.monotonic by default,
        tests inject a virtual clock.
    priority_aging_sec: scheduler aging (one class per this many seconds).
    prefix_cache: the block-paged KV store with radix prefix sharing;
        ``block_size`` tokens per block, ``num_blocks`` pool blocks (default:
        every slot can hold a full ``max_len`` request, nothing shared).
    kv_dtype: None (the compute dtype), "int8" or "fp8": the block pool's
        storage (needs ``prefix_cache``).
    prefill_token_budget: chunked prefill: bucket-padded prompt tokens
        prefilled per iteration (None: each prompt in one prefill).
    preemption: "swap" for priority preemption with host KV swap.
    swap_max_bytes: cap on the host swap buffer's bytes (None: unbounded);
        a preemption that would pass it is declined.
    tpot_slo_ms, slo_max_defer: the TPOT guard (needs the budget).
    speculative: None/"off", "ngram" or "draft", a dict of
        :class:`~deepspeed_tpu_torch.serving.speculative.SpeculativeConfig`
        fields, or a config: speculative decoding.
    tracer: a :class:`~deepspeed_tpu_torch.telemetry.spans.SpanTracer`
        (None: untraced); arming it also records each program call's wall
        for :meth:`attribution_table`.
    telemetry: True (default) records into the global registry
        (telemetry/registry.py), a registry records there, None/False
        records nothing.
    slo: a :class:`~deepspeed_tpu_torch.telemetry.slo.SLOEngine`, evaluated
        once per iteration on the engine's clock (None: off).
    tenants: per-tenant accounting (telemetry/tenants.py): None follows
        ``telemetry`` (into the same registry), True forces a ledger
        (registry-less without telemetry), False turns it off.
    """

    def __init__(self, engine, *, num_slots: int = 8, max_len: int = 1024,
                 buckets: Sequence[int] = (128, 512, 2048),
                 eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 time_fn: Optional[Callable[[], float]] = None,
                 telemetry=True, speculative=None,
                 prefix_cache: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 prefill_token_budget: Optional[int] = None,
                 preemption: Optional[str] = None,
                 swap_max_bytes: Optional[int] = None,
                 priority_aging_sec: Optional[float] = None,
                 tpot_slo_ms: Optional[float] = None,
                 slo_max_defer: int = 4, tracer=None, slo=None,
                 tenants: Optional[bool] = None):
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
            # its hit/miss/COW/eviction counters land beside the serving
            # histograms
            self.prefix: Optional[PrefixCache] = PrefixCache(
                self.cache, registry=self.telemetry)
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
        self.buckets = tuple(sorted({min(b, max_len) for b in buckets}))
        if not self.buckets:
            raise EngineConfigError(f"no prefill buckets given: {buckets}")
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.device = engine.device
        self.do_sample = do_sample
        self._temp = max(float(temperature), 1e-6)
        self._sample_kw = dict(do_sample=do_sample, top_k=top_k,
                               top_p=float(top_p))
        # sampled picks draw from this generator (the reference's
        # PRNGKey(seed + 1)); greedy programs take None
        self._rng = torch.Generator(device=self.device).manual_seed(
            engine.config.seed + 1) if do_sample else None
        # the decode step's CUDA graphs read this engine's KV store, so
        # they are this engine's (on the inference engine's graph pool)
        self._decode = GraphProgram(
            self.cache.decode_program(engine, pad_token_id, **self._sample_kw),
            engine.graph_pool)
        pin = torch.device(self.device).type == "cuda"

        # ---- speculative decoding
        self.spec = normalize_speculative(speculative)
        self._verify: Dict[int, GraphProgram] = {}
        # k-bucket -> the verify block's pinned host and device buffers
        self._verify_tokens: Dict[int, tuple] = {}
        self._drafter = None
        self._adaptive = None
        self._lookahead = 0
        if self.spec is not None:
            # the verify writes the k drafts' K/V before acceptance: the
            # lookahead rows are reserved at admission
            self._lookahead = self.spec.k_max
            if max_len <= self._lookahead:
                raise EngineConfigError(
                    f"speculative k_max {self._lookahead} leaves no slot "
                    f"capacity at max_len {max_len}")
            if self.spec.mode == "draft":
                self._drafter = DraftModelDrafter(
                    self.spec, num_slots, pad_token_id=pad_token_id,
                    device=self.device)
            else:
                self._drafter = NgramDrafter(self.spec)
            if self.spec.adaptive:
                self._adaptive = AdaptiveK(self.spec, num_slots)
            # the verify steps' per-step draft lengths (pinned host, device)
            self._draft_len_host = torch.zeros((num_slots,),
                                               dtype=torch.int32,
                                               pin_memory=pin)
            self._draft_len = torch.zeros((num_slots,), dtype=torch.int32,
                                          device=self.device)
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self._draft_wall = 0.0
        self._verify_wall = 0.0

        # ---- SLO control plane and per-tenant accounting
        self.slo = slo
        if tenants is None:
            tenants = self.telemetry is not None
        self.tenants = TenantLedger(self.telemetry) if tenants else None
        # KV occupancy is billed at payload bytes per pool block (a
        # quantized pool's blocks at what they cost); slot-paged, the whole
        # slot row is one block
        if prefix_cache:
            self._kv_bytes_per_block = (
                pool_payload(self.cache.k).nbytes
                + pool_payload(self.cache.v).nbytes) / (self.cache.num_blocks
                                                        + 1)
        else:
            self._kv_bytes_per_block = (
                self.cache.k.nbytes + self.cache.v.nbytes) / num_slots
        self._acct_last_t: Optional[float] = None

        # ---- span tracing and per-program attribution
        self.tracer = tracer
        # program name -> [total host wall s, calls, rows]: armed runs only
        # (the bare path keeps no clock of its own); rows are the context or
        # moved K/V rows the calls touched (telemetry/attribution.work_cost)
        self._prog_wall: Dict[str, list] = {}
        self._attr_cache: Dict[tuple, dict] = {}
        self._rtraces: Dict[int, _ReqTrace] = {}
        self._engine_trace: Optional[str] = None   # iteration spans' trace
        self._last_step_now = 0.0     # cancel() takes no clock argument
        # context-carrying records awaiting their submit-time stamp (the
        # next step's)
        self._pending_submit_stamps: List[_ReqTrace] = []

        # ---- SLO-aware scheduling
        if prefill_token_budget is not None:
            if prefill_token_budget < self.buckets[0]:
                raise EngineConfigError(
                    f"prefill_token_budget {prefill_token_budget} below the "
                    f"smallest prefill bucket {self.buckets[0]}: no chunk "
                    f"program could ever run under it")
            # chunks are the largest bucket the budget holds (the chunk
            # count is data, the bucket set fixed)
            self._chunk_max: Optional[int] = max(
                b for b in self.buckets if b <= prefill_token_budget)
        else:
            self._chunk_max = None
        self.prefill_token_budget = prefill_token_budget
        if preemption not in (None, "swap"):
            raise EngineConfigError(f"preemption policy must be None or "
                                    f"'swap', got {preemption!r}")
        self.preemption = preemption
        self.swap = HostSwapBuffer(max_bytes=swap_max_bytes) \
            if preemption else None
        self._preempted: Dict[int, _Preempted] = {}
        if tpot_slo_ms is not None and prefill_token_budget is None:
            raise EngineConfigError(
                "tpot_slo_ms needs prefill_token_budget: the SLO guard "
                "defers budgeted prefill work, and monolithic admission "
                "has no budget to defer")
        self.tpot_slo_ms = tpot_slo_ms
        self._slo_max_defer = slo_max_defer
        self._defer_streak = 0
        self._decode_gap_ema: Optional[float] = None
        self._last_decode_t: Optional[float] = None
        self._admit_seq = 0

        # the decode step's per-step inputs: host arrays (pinned on the
        # card) copied into persistent device buffers, the addresses the
        # step's CUDA graph reads (the verify steps read ``_active`` too)
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
        # slot-paged chunk prefills (block-paged chunks run the suffix
        # prefill from their offset)
        self._chunk_prefill: Dict[int, Callable] = {}
        self._swap_out_fn: Optional[Callable] = None
        self._swap_in_fn: Optional[Callable] = None
        self.decode_steps = 0
        self.decode_wall = 0.0
        self.prefill_calls = 0
        self.tokens_generated = 0
        self._active_slot_iterations = 0
        # prompt tokens run through a prefill (the unmatched suffixes in
        # block-paged mode: radix-matched tokens never reach the device)
        self.prefill_tokens_computed = 0
        self.prefill_chunks = 0
        self.preemptions = 0
        # swap traffic in pool blocks (block-paged) or slot pages (the
        # slot's whole row, one per trip)
        self.swapped_blocks_out = 0
        self.swapped_blocks_in = 0
        self.swap_capacity_rejections = 0
        self.slo_deferred_steps = 0
        log_dist(f"ServingEngine: slots={num_slots} max_len={max_len} "
                 f"buckets={self.buckets} cache={self.cache!r}", ranks=[0])

    # ---------------------------------------------------------- programs
    def _prefill_fn(self, bucket: int):
        if bucket not in self._prefill:
            self._prefill[bucket] = self.cache.prefill_program(
                self.engine, bucket, **self._sample_kw)
        return self._prefill[bucket]

    def _chunk_fn(self, bucket: int):
        """Slot-paged mid-prompt chunk prefill (it starts at an offset into
        the slot's own row, where the monolithic prefill starts at 0)."""
        if bucket not in self._chunk_prefill:
            self._chunk_prefill[bucket] = self.cache.chunk_program(
                self.engine, bucket, **self._sample_kw)
        return self._chunk_prefill[bucket]

    def _build_swap_programs(self) -> None:
        """The preemption swap-out and swap-in programs (built at warm-up
        when the policy is on, so a first preemption builds nothing)."""
        if self._swap_out_fn is None:
            self._swap_out_fn, self._swap_in_fn = \
                self.cache.swap_programs(self.engine)

    def _verify_fn(self, kb: int) -> GraphProgram:
        """The verify program of k-bucket ``kb`` (one per bucket of the
        fixed set, so adaptive k never builds one), this engine's graph,
        and its block's pinned host and device buffers."""
        if kb not in self._verify:
            self._verify[kb] = GraphProgram(
                self.cache.verify_program(self.engine, kb, self.pad_token_id,
                                          **self._sample_kw),
                self.engine.graph_pool)
            pin = torch.device(self.device).type == "cuda"
            shape = (self.num_slots, kb + 1)
            self._verify_tokens[kb] = (
                torch.zeros(shape, dtype=torch.int32, pin_memory=pin),
                torch.zeros(shape, dtype=torch.int32, device=self.device))
        return self._verify[kb]

    def _verify_call(self, kb: int, rng: Optional[torch.Generator]):
        """Copy the pinned per-step inputs (the ``[B, kb+1]`` block, draft
        lengths, active mask) to their device buffers and run (on the card:
        replay) the verify program of bucket ``kb``."""
        fn = self._verify_fn(kb)
        host, dev = self._verify_tokens[kb]
        dev.copy_(host, non_blocking=True)
        self._draft_len.copy_(self._draft_len_host, non_blocking=True)
        self._active.copy_(self._active_host, non_blocking=True)
        return fn(self.engine.params, *self.cache.carry(),
                  *self.cache.decode_args(), dev, self._draft_len,
                  self._active, self._temp, rng)

    @property
    def program_count(self) -> int:
        """Serving programs built so far, as the reference counts them: one
        prefill per bucket used, the decode step, the slot-paged chunk
        prefills, the swap-out and swap-in pair, with the prefix cache the
        copy-on-write block copy, and with speculation one verify program
        per k-bucket and the draft model's programs (``len(buckets) + 1``
        after warm-up with no option, + 1 block-paged)."""
        n = (len(self._prefill) + 1 + len(self._chunk_prefill)
             + len(self._verify) + 2 * (self._swap_out_fn is not None)
             + (self._copy_fn is not None))
        if self._drafter is not None:
            n += len(self._drafter.program_cache_sizes())
        return n

    def program_cache_sizes(self) -> Dict[str, int]:
        """Entry count per serving program, by the reference's names: each
        must stay 1 after any trace (a second entry means an operand's
        shape or dtype varied; on the card, a second capture)."""
        out = {"decode": self._decode._cache_size()}
        for b, fn in self._prefill.items():
            out[f"prefill_{b}"] = fn._cache_size()
        for b, fn in self._chunk_prefill.items():
            out[f"chunk_prefill_{b}"] = fn._cache_size()
        for kb, fn in self._verify.items():
            out[f"verify_{kb}"] = fn._cache_size()
        if self._swap_out_fn is not None:
            out["swap_out"] = self._swap_out_fn._cache_size()
            out["swap_in"] = self._swap_in_fn._cache_size()
        if self._copy_fn is not None:
            out["block_copy"] = self._copy_fn._cache_size()
        if self._drafter is not None:
            out.update(self._drafter.program_cache_sizes())
        return out

    def recompile_count(self) -> int:
        """Entries past the first across the serving programs: any value
        above 0 means a program recompiled (was captured again) after
        warm-up."""
        return sum(max(0, v - 1) for v in self.program_cache_sizes().values())

    # ------------------------------------------------------- attribution
    def _prog_note(self, name: str, dt: float, rows: float = 0) -> None:
        """Add one call's host wall (and the context or moved K/V rows it
        touched) to program ``name``'s total (armed runs)."""
        w = self._prog_wall.get(name)
        if w is None:
            self._prog_wall[name] = [dt, 1, rows]
        else:
            w[0] += dt
            w[1] += 1
            w[2] += rows

    def _program_map(self) -> Dict[str, Callable]:
        """name -> program, by the names of :meth:`program_cache_sizes`
        (the draft model's programs included)."""
        progs: Dict[str, Callable] = {"decode": self._decode}
        for b, fn in self._prefill.items():
            progs[f"prefill_{b}"] = fn
        for b, fn in self._chunk_prefill.items():
            progs[f"chunk_prefill_{b}"] = fn
        for kb, fn in self._verify.items():
            progs[f"verify_{kb}"] = fn
        if self._swap_out_fn is not None:
            progs["swap_out"] = self._swap_out_fn
            progs["swap_in"] = self._swap_in_fn
        if self._copy_fn is not None:
            progs["block_copy"] = self._copy_fn
        if isinstance(self._drafter, DraftModelDrafter):
            for kb, fn in self._drafter._programs.items():
                progs[f"draft_{kb}"] = fn
        return progs

    def _model_costs(self):
        """(target, draft) :class:`~deepspeed_tpu_torch.telemetry.
        attribution.ModelCost`: the serving model over this engine's KV
        store, and the draft model over its drafter's cache (None without
        one)."""
        def cost(engine, kv_bytes, rows):
            return model_cost(engine.params, engine.module.config,
                              kv_row_bytes=kv_bytes / rows,
                              compute_itemsize=engine.dtype.itemsize)

        c = self.cache
        rows = ((c.num_blocks + 1) * c.block_size if self.prefix is not None
                else self.num_slots * self.max_len)
        target = cost(self.engine, c.hbm_bytes(), rows)
        draft = None
        if isinstance(self._drafter, DraftModelDrafter):
            d = self._drafter
            draft = cost(d.engine, d.k.nbytes + d.v.nbytes,
                         d.k.shape[1] * d.k.shape[3])
        return target, draft

    def attribution_table(self) -> Dict[str, dict]:
        """Per-program roofline rows (telemetry/attribution.py): each
        serving program's analytic FLOPs and bytes per call (the rows a
        call touched averaged over the timed calls) joined with its mean
        host wall per call (tracer-armed runs) and the card's roofs.
        Never called from the serving loop."""
        target, draft = self._model_costs()
        walls, progs = {}, {}
        for name, fn in self._program_map().items():
            w = self._prog_wall.get(name)
            if w is not None:
                walls[name] = (w[0], w[1])
            mc = draft if name.startswith("draft_") else target
            work = getattr(fn, "program", fn).work
            progs[name] = (partial(work_cost, mc),
                           (work, w[2] / w[1] if w is not None else 0.0))
        return attribution_table(progs, walls=walls, cache=self._attr_cache,
                                 device_name=self.engine.accelerator
                                 .device_name())

    def record_attribution(self) -> Dict[str, dict]:
        """:meth:`attribution_table`, also written to the telemetry JSONL
        sink as an ``{"kind": "attribution"}`` record (rendered by
        scripts/telemetry_report.py's attribution section)."""
        table = self.attribution_table()
        if self.telemetry is not None and self.telemetry.sink is not None:
            self.telemetry.sink.write({"kind": "attribution",
                                       "scope": "serving",
                                       "programs": table})
        return table

    def warmup(self) -> None:
        """Run every serving program once on dummy data: each bucket's
        prefill (slot-paged under a budget: and its chunk prefill, for the
        buckets a chunk can take), with preemption the swap round trip, the
        decode step (block-paged: and the block copy, the garbage row onto
        itself), with speculation each k-bucket's verify step (no slot
        active) and draft program, then reset the slot lengths. The decode
        call builds the CUDA kernels and captures the step's CUDA graph,
        off the served trace, as do the verify and draft calls theirs. Block-paged warm-up prefills and swaps through sentinel
        table rows, so its writes land in the garbage row. A sampling
        engine warms up on a generator of its own: the served trace's draws
        start from the engine's seed."""
        if self._warm:
            return
        params = self.engine.params
        paged = self.prefix is not None
        rng = (torch.Generator(device=self.device).manual_seed(0)
               if self.do_sample else None)
        for b in self.buckets:
            ids = torch.zeros((1, b), dtype=torch.long, device=self.device)
            out = self._prefill_fn(b)(params, *self.cache.carry(), ids,
                                      *self.cache.prefill_args(0, 0, 1),
                                      self._temp, rng)
            self.cache.update(*out[:3])
            if (self._chunk_max is not None and not paged
                    and b <= self._chunk_max):
                out = self._chunk_fn(b)(params, *self.cache.carry(), ids,
                                        *self.cache.chunk_args(0, 0, 1),
                                        self._temp, rng)
                self.cache.update(*out[:3])
        if self.preemption is not None:
            self._build_swap_programs()
            self.cache.warm_swap(self._swap_out_fn, self._swap_in_fn)
        self._active.zero_()
        out = self._decode(params, *self.cache.carry(),
                           *self.cache.decode_args(), self._toks, self._active,
                           self._temp, rng)
        self.cache.update(*out[:3])
        if self._copy_fn is not None:
            # the copy-on-write program: the garbage row onto itself
            self.cache.update_kv(*self._copy_fn(
                self.cache.k, self.cache.v, self.cache.sentinel,
                self.cache.sentinel))
        if self.spec is not None:
            self._active_host.zero_()
            self._draft_len_host.zero_()
            for kb in self.spec.k_buckets:
                self._verify_fn(kb)
                self._verify_tokens[kb][0].fill_(self.pad_token_id)
                self.cache.update(*self._verify_call(kb, rng)[:3])
            self._drafter.warmup()
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
        if self._chunk_max is None and pick_bucket(plen, self.buckets) is None:
            raise PromptTooLongError(
                f"request {request.rid}: prompt length {plen} exceeds the "
                f"largest prefill bucket {self.buckets[-1]} (set "
                f"prefill_token_budget to serve longer prompts via "
                f"chunked prefill)")
        if not self.cache.capacity_for(plen, request.max_new_tokens,
                                       self._lookahead):
            extra = (f" (speculation reserves {self._lookahead} lookahead "
                     f"rows for pre-acceptance draft writes)"
                     if self._lookahead else "")
            raise SlotCapacityError(
                f"request {request.rid}: prompt {plen} + max_new "
                f"{request.max_new_tokens} exceeds slot capacity "
                f"{self.max_len}{extra}")
        if self.tracer is not None:
            # a request with trace context keeps its trace and hangs its
            # spans under the caller's span; else the engine owns the root.
            # The Request is not changed: the context lives here
            if request.trace_id is not None:
                rt = _ReqTrace(request.trace_id, request.parent_span)
                self._rtraces[request.rid] = rt
                self._pending_submit_stamps.append(rt)
            else:
                root = self.tracer.begin(
                    "request", t=request.arrival_time, rid=request.rid,
                    priority=request.priority, prompt_len=plen)
                self._rtraces[request.rid] = _ReqTrace(
                    root.trace_id, root.span_id, root_span=root)
        self.scheduler.submit(request)

    def cancel(self, rid: int) -> bool:
        """Withdraw a request wherever it is. Queued: removed from the
        scheduler (a preempted request's parked KV is dropped, not counted
        as a swap-in). Running: its slot is freed; block-paged, the blocks
        it computed are donated to the radix index (valid prefixes; an
        unwritten tail is not) and the rest freed. False when the rid is
        unknown or finished; a cancelled request emits no result."""
        if self.scheduler.remove(rid):
            if self._preempted.pop(rid, None) is not None:
                self.swap.discard(rid)
            self._trace_cancel(rid, "queued")
            return True
        for i, st in enumerate(self._slots):
            if st is not None and st.request.rid == rid:
                self._slots[i] = None
                self.scheduler.release(i)
                if self.prefix is not None:
                    # the computed length caps the donation (a host read)
                    self.prefix.finish(i, donate_upto=int(
                        self.cache.lengths[i]))
                self._trace_cancel(rid, "slot")
                return True
        return False

    def _trace_cancel(self, rid: int, where: str) -> None:
        """Close a cancelled request's open spans at the last step's
        instant (cancel takes no clock argument)."""
        if self.tracer is None:
            return
        rt = self._rtraces.pop(rid, None)
        if rt is None:
            return
        t = self._last_step_now
        self.tracer.end(rt.decode_span, t=t, reason="cancelled")
        self.tracer.end(rt.swap_span, t=t, reason="cancelled")
        self.tracer.record("cancel", t, t, trace_id=rt.trace_id,
                           parent_id=rt.root, where=where)
        self.tracer.end(rt.root_span, t=t, finish_reason="cancelled")

    @property
    def pending(self) -> int:
        """Requests not yet finished (queued + in flight)."""
        return self.scheduler.waiting + sum(s is not None for s in self._slots)

    # --------------------------------------------------------- iteration
    def _next_rng(self) -> Optional[torch.Generator]:
        """The generator a program call draws from (None when greedy); each
        draw advances it."""
        return self._rng

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
        if self.tracer is not None:
            rt = self._rtraces.pop(st.request.rid, None)
            if rt is not None:
                t_fin = st.result.finish_time
                self.tracer.end(rt.decode_span, t=t_fin,
                                tokens=len(st.result.tokens),
                                decode_calls=st.result.decode_calls)
                self.tracer.end(rt.swap_span, t=t_fin)
                self.tracer.end(rt.root_span, t=t_fin, finish_reason=reason,
                                tokens=len(st.result.tokens),
                                preemptions=st.result.preemptions)
        if self.telemetry is not None:
            res, reg = st.result, self.telemetry
            reg.counter("serving/finished_requests").inc()
            reg.histogram("serving/latency_ms").observe(res.latency * 1e3)
            # decode-phase iterations only: TTFT covers the prefill, and
            # time preempted after the first token is queue wait. Divided
            # by decode invocations, not tokens: a verify emits up to k + 1
            if res.decode_calls > 0:
                tpot = max(res.finish_time - res.first_token_time
                           - res.decode_preempted_wall,
                           0.0) / res.decode_calls * 1e3
                reg.histogram("serving/tpot_ms").observe(tpot)
                reg.histogram(
                    f"serving/tpot_ms/p{metric_label(res.priority)}"
                ).observe(tpot)
                reg.histogram("serving/tokens_per_decode_call",
                              buckets=_TOKENS_PER_STEP_BUCKETS).observe(
                    (len(res.tokens) - 1) / res.decode_calls)
                if self.tenants is not None:
                    self.tenants.note_tpot(st.tenant, tpot)
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
        """The scheduler's ``fits`` hook: slot-paged, a free slot suffices;
        block-paged admission (a fresh request or a resume alike) needs the
        request's unmatched blocks (prompt + max_new + the speculative
        lookahead, minus radix-matched full blocks) from free + evictable
        pool blocks."""
        if self.prefix is None:
            return True
        return self.prefix.fits(req.prompt, self._span_of(req))

    def _span_of(self, req: Request) -> int:
        """Positions a request may write: prompt, new tokens, lookahead."""
        return len(req.prompt) + req.max_new_tokens + self._lookahead

    @staticmethod
    def _stream(st: _SlotState, tokens) -> None:
        cb = st.request.on_token
        if cb is not None:
            for t in tokens:
                cb(int(t))

    def _iteration_prefill_budget(self, now: float) -> Optional[int]:
        """Prefill tokens this iteration may spend (None: unlimited,
        monolithic). With ``tpot_slo_ms``, an iteration whose decode-gap
        average exceeds it while decode-phase slots exist defers all
        prefill (returns 0), at most ``slo_max_defer`` times in a row. The
        streak counts only iterations with prefill work to defer (a chunked
        prompt in flight or an arrived fresh head)."""
        budget = self.prefill_token_budget
        if budget is None:
            return None
        at_risk = (self.tpot_slo_ms is not None
                   and self._decode_gap_ema is not None
                   and self._decode_gap_ema * 1e3 > self.tpot_slo_ms
                   and any(s is not None and not s.prefilling
                           for s in self._slots))
        if not at_risk:
            self._defer_streak = 0
            return budget
        head = self.scheduler.peek(now)
        work = (any(s is not None and s.prefilling for s in self._slots)
                or (head is not None and head.rid not in self._preempted))
        if not work:
            return budget       # nothing to defer; streak untouched
        if self._defer_streak >= self._slo_max_defer:
            self._defer_streak = 0
            return budget
        self._defer_streak += 1
        self.slo_deferred_steps += 1
        if self.telemetry is not None:
            self.telemetry.counter("serving/slo_deferred_steps").inc()
        return 0

    def _schedule(self, now: float, finished: List[RequestResult]) -> None:
        """The admit/prefill side of one iteration, under its prefill
        budget: in-flight chunked prefills first (class, then admission
        order), except those the queue head strictly outranks, whose share
        is yielded to it; then admissions one request per scheduler call
        (each takes resources the next ``fits`` check must see), preempting
        lower-class slots when the policy allows; then any leftover budget
        back to the prefills still in flight. A resume is a copy, not
        prefill compute, so it spends no budget."""
        budget = self._iteration_prefill_budget(now)
        spent = self._continue_prefills(now, budget, 0, finished,
                                        yield_to_head=True)
        while True:
            if budget is not None and spent >= budget:
                head = self.scheduler.peek(now)
                if head is None or head.rid not in self._preempted:
                    break
            pairs = self.scheduler.admit(now, fits=self._admit_fits, limit=1)
            if not pairs:
                if not self._try_preempt(now):
                    break
                continue
            (req, slot), = pairs
            if req.rid in self._preempted:
                self._resume(slot, req, now)
                continue
            spent += self._admit_one(
                slot, req, now, None if budget is None else budget - spent,
                finished)
        self._continue_prefills(now, budget, spent, finished,
                                yield_to_head=False)

    def _continue_prefills(self, now: float, budget: Optional[int],
                           spent: int, finished: List[RequestResult],
                           yield_to_head: bool) -> int:
        """Advance in-flight chunked prefills in (class, admission) order
        under the remaining budget. With ``yield_to_head``, a slot that the
        best arrived queue head strictly outranks (raw class and aged
        priority, preemption's guard) is skipped: its share goes to the
        head. Returns the budget spent so far."""
        head = self.scheduler.peek(now) if yield_to_head else None
        eff = self.scheduler.effective_priority
        pre = sorted((i for i, s in enumerate(self._slots)
                      if s is not None and s.prefilling),
                     key=lambda i: (self._slots[i].request.priority,
                                    self._slots[i].order))
        for slot in pre:
            if budget is not None and spent >= budget:
                break
            st = self._slots[slot]
            if (head is not None and head.priority < st.request.priority
                    and eff(head, now) < eff(st.request, now)):
                continue
            spent += self._run_prefill_chunks(
                slot, now, None if budget is None else budget - spent,
                finished)
        return spent

    def _admit_one(self, slot: int, req: Request, now: float,
                   budget_left: Optional[int],
                   finished: List[RequestResult]) -> int:
        """Admit one fresh request into ``slot``: shed it if its deadline
        passed, else (block-paged: match the prompt against the radix index
        and run the copy-on-write forks) prefill as much of the prompt, or
        of its unmatched suffix, as the budget allows. Returns the prefill
        tokens spent."""
        plen = len(req.prompt)
        if req.deadline is not None and now > req.deadline:
            self.scheduler.release(slot)
            res = RequestResult(rid=req.rid, prompt_len=plen,
                                arrival_time=req.arrival_time,
                                admitted_time=now, priority=req.priority)
            res.finish_time = self._now(now)
            res.finish_reason = "shed_deadline"
            finished.append(res)
            if self.telemetry is not None:
                self.telemetry.counter("serving/shed_deadline").inc()
            if self.tenants is not None:
                self.tenants.note_shed(self.tenants.resolve(req.tenant_id))
            if self.tracer is not None:
                rt = self._rtraces.pop(req.rid, None)
                if rt is not None:
                    t_q0 = req.arrival_time if rt.submitted_t is None \
                        else rt.submitted_t
                    self.tracer.record("queue_wait", min(t_q0, now), now,
                                       trace_id=rt.trace_id,
                                       parent_id=rt.root, slot=slot)
                    self.tracer.end(rt.root_span, t=res.finish_time,
                                    finish_reason="shed_deadline")
            return 0
        start = 0
        if self.prefix is not None:
            start, copies = self.prefix.admit(slot, req.prompt,
                                              self._span_of(req))
            for src, dst in copies:
                w0 = time.perf_counter() if self.tracer is not None else 0.0
                self.cache.update_kv(*self._copy_fn(
                    self.cache.k, self.cache.v, src, dst))
                if self.tracer is not None:
                    self._prog_note("block_copy", time.perf_counter() - w0)
        res = RequestResult(rid=req.rid, prompt_len=plen,
                            arrival_time=req.arrival_time,
                            admitted_time=now, priority=req.priority)
        tenant = self.tenants.resolve(req.tenant_id) \
            if self.tenants is not None else "default"
        self._slots[slot] = _SlotState(req, res, last_token=0,
                                       prefill_pos=start, prefill_total=plen,
                                       order=self._admit_seq, tenant=tenant)
        self._admit_seq += 1
        if self.tenants is not None:
            # the prompt lands on the bill at admission; radix-matched
            # tokens are the prefix cache's dividend to the tenant
            self.tenants.note_admitted(tenant, plen)
            if start:
                self.tenants.note_prefill(tenant, 0, saved=start)
        if self.telemetry is not None:
            self.telemetry.counter("serving/prefills").inc()
            self.telemetry.histogram("serving/queue_wait_ms").observe(
                max(now - req.arrival_time, 0.0) * 1e3)
        if self.tracer is not None:
            rt = self._rtraces.get(req.rid)
            if rt is not None:
                t_q0 = req.arrival_time if rt.submitted_t is None \
                    else rt.submitted_t
                self.tracer.record(
                    "queue_wait", min(t_q0, now), now, trace_id=rt.trace_id,
                    parent_id=rt.root, slot=slot, priority=req.priority,
                    radix_matched_tokens=start)
        if self._adaptive is not None:
            self._adaptive.reset_slot(slot)
        return self._run_prefill_chunks(slot, now, budget_left, finished)

    def _run_prefill_chunks(self, slot: int, now: float,
                            budget_left: Optional[int],
                            finished: List[RequestResult]) -> int:
        """Advance slot ``slot``'s prefill by whole chunks until its prompt
        is done or the budget is spent (monolithic: one chunk, the whole
        prompt). Budget is charged in bucket-padded tokens, the compute
        dispatched. Only the last chunk's pick is read (the first token,
        which stamps TTFT)."""
        st = self._slots[slot]
        req = st.request
        spent = 0
        while st.prefilling and (budget_left is None or spent < budget_left):
            remaining = st.prefill_total - st.prefill_pos
            chunk = remaining if self._chunk_max is None \
                else min(remaining, self._chunk_max)
            last = st.prefill_pos + chunk == st.prefill_total
            bucket = pick_bucket(chunk, self.buckets)
            ids = np.full((1, bucket), self.pad_token_id, np.int64)
            ids[0, :chunk] = np.asarray(
                req.prompt[st.prefill_pos:st.prefill_pos + chunk], np.int64)
            ids = torch.from_numpy(ids).to(self.device)
            pos = st.prefill_pos
            if self.prefix is None and (pos > 0 or not last):
                # a chunk of the prompt, from its offset in the slot's row
                pname = f"chunk_prefill_{bucket}"
                fn, args = self._chunk_fn(bucket), self.cache.chunk_args(
                    slot, pos, chunk)
            else:
                # the whole prompt at once (slot-paged), or a suffix or a
                # chunk of it from its offset (block-paged)
                pname = f"prefill_{bucket}"
                fn, args = self._prefill_fn(bucket), self.cache.prefill_args(
                    slot, pos, chunk)
            armed = self.tracer is not None
            if armed:
                t_span0 = self._now(now)
                t_wall0 = time.perf_counter()
            out = fn(self.engine.params, *self.cache.carry(), ids, *args,
                     self._temp, self._next_rng())
            self.cache.update(*out[:3])
            if armed:
                # stamped around the dispatch; the last chunk's token read
                # below is the fence the bare engine pays as well. The chunk
                # attends to the ``pos`` rows before it
                self._prog_note(pname, time.perf_counter() - t_wall0, pos)
                rt = self._rtraces.get(req.rid)
                if rt is not None:
                    self.tracer.record(
                        "prefill_chunk", t_span0, self._now(now),
                        trace_id=rt.trace_id, parent_id=rt.root,
                        program=pname, bucket=bucket, tokens=chunk,
                        slot=slot)
            st.prefill_pos += chunk
            spent += bucket
            self.prefill_tokens_computed += chunk
            self.prefill_chunks += 1
            st.result.prefill_chunks += 1
            if self.telemetry is not None:
                self.telemetry.counter("serving/prefill_chunks").inc()
            if self.tenants is not None:
                # billed with the engine counter, so the tenants' computed
                # tokens sum exactly to it
                self.tenants.note_prefill(st.tenant, chunk)
            if last:
                tok = int(out[3])      # the token must reach the host stream
                self.prefill_calls += 1
                self.tokens_generated += 1
                st.last_token = tok
                st.result.tokens.append(tok)
                t_emit = self._now(now)
                st.result.first_token_time = t_emit
                st.result.token_times.append(t_emit)
                ttft = max(t_emit - req.arrival_time, 0.0) * 1e3
                if self.telemetry is not None:
                    self.telemetry.histogram("serving/ttft_ms").observe(ttft)
                    self.telemetry.histogram(
                        f"serving/ttft_ms/p{metric_label(req.priority)}"
                    ).observe(ttft)
                if self.tenants is not None:
                    self.tenants.note_tokens(st.tenant, 1)
                    self.tenants.note_ttft(st.tenant, ttft)
                self._stream(st, [tok])
                if armed:
                    # decode-phase residency, from the first token to the
                    # finish, preemption or cancel
                    rt = self._rtraces.get(req.rid)
                    if rt is not None:
                        rt.decode_span = self.tracer.begin(
                            "decode_segment", trace_id=rt.trace_id,
                            parent_id=rt.root, t=t_emit, slot=slot)
                done = self._maybe_finish(slot, now)
                if done is not None:
                    finished.append(done)
        return spent

    # -------------------------------------------------------- preemption
    def _try_preempt(self, now: float) -> bool:
        """Make room for the best waiting request by swapping out one
        running slot of a strictly worse class, once admission came up
        empty. The victim's raw class and its aged priority must both be
        worse than the candidate's (else, requeued, it would rank ahead of
        the candidate and swap straight back in). Victim: the worst class,
        and within it the latest admitted (the least sunk work). Returns
        True if a slot was freed."""
        if self.preemption is None:
            return False
        cand = self.scheduler.peek(now)
        if cand is None:
            return False
        eff = self.scheduler.effective_priority
        cand_eff = eff(cand, now)
        victims = [i for i, s in enumerate(self._slots)
                   if s is not None and s.request.priority > cand.priority
                   and eff(s.request, now) > cand_eff]
        if not victims:
            return False
        victim = max(victims, key=lambda i: (self._slots[i].request.priority,
                                             self._slots[i].order))
        try:
            self._preempt(victim, now)
        except SwapCapacityError:
            # the buffer is at its cap: declined before any engine state
            # changed; the candidate waits for a slot to free
            self.swap_capacity_rejections += 1
            if self.telemetry is not None:
                self.telemetry.counter(
                    "serving/swap_capacity_rejections").inc()
            return False
        return True

    def _preempt(self, slot: int, now: float) -> None:
        """Swap slot ``slot``'s KV out to the host buffer and requeue its
        request at its original place. Its slot state (emitted tokens,
        chunk progress) is parked and reattached on resume, so it finishes
        with the tokens of an uninterrupted run."""
        st = self._slots[slot]
        self._build_swap_programs()
        armed = self.tracer is not None
        rt = self._rtraces.get(st.request.rid) if armed else None
        if armed:
            t_sw0 = self._now(now)
            w0 = time.perf_counter()
        # the length the slot computed bounds what is parked (a host read)
        length = int(self.cache.lengths[slot])
        host_k, host_v, n_used = self.cache.swap_out(self._swap_out_fn, slot,
                                                     length)
        self.swap.put(st.request.rid, host_k, host_v)
        if self.prefix is not None:
            # the computed full prompt blocks go to the radix index (a
            # resume usually re-matches them and skips their upload); the
            # cap keeps a mid-prefill slot's unwritten blocks out
            self.prefix.finish(slot, donate_upto=length)
        self.swapped_blocks_out += n_used
        self._slots[slot] = None
        self.scheduler.release(slot)
        self.scheduler.resubmit(st.request)
        st.result.preemptions += 1
        since = self._now(now)
        self._preempted[st.request.rid] = _Preempted(st, length, since)
        if rt is not None:
            # the decode segment ends where the swap began; the swapped
            # interval opens at the park and closes on resume
            self.tracer.end(rt.decode_span, t=t_sw0, reason="preempted")
            rt.decode_span = None
            self.tracer.record("swap_out", t_sw0, since, trace_id=rt.trace_id,
                               parent_id=rt.root, program="swap_out",
                               blocks=n_used, slot=slot)
            rt.swap_span = self.tracer.begin(
                "swapped", trace_id=rt.trace_id, parent_id=rt.root, t=since,
                blocks=n_used)
        if armed:
            # block-paged, the blocks parked; slot-paged, the whole row
            # (the program's own count)
            self._prog_note("swap_out", time.perf_counter() - w0,
                            n_used * self.cache.block_size
                            if self.prefix is not None else 0)
        self.preemptions += 1
        if self.tenants is not None:
            self.tenants.note_preemption(st.tenant)
        if self.telemetry is not None:
            reg = self.telemetry
            reg.counter("serving/preemptions").inc()
            reg.counter("serving/swapped_blocks_out").inc(n_used)

    def _resume(self, slot: int, req: Request, now: float) -> None:
        """Swap a preempted request back into ``slot``: upload its parked
        KV, restore its length and reattach its slot state. Block-paged,
        the prompt is re-matched first: still-cached full prefix blocks are
        re-pinned and not uploaded (a longer prefix cached meanwhile moves
        a mid-prefill resume past it)."""
        rec = self._preempted.pop(req.rid)
        st = rec.state
        rt = self._rtraces.get(req.rid) if self.tracer is not None else None
        if self.tracer is not None:
            t_in0 = self._now(now)
            w0 = time.perf_counter()
        host_k, host_v = self.swap.pop(req.rid)
        length = rec.length
        shared = 0
        if self.prefix is not None:
            shared = self.prefix.readmit(slot, req.prompt,
                                         self._span_of(req))
            length = max(length, min(shared * self.cache.block_size,
                                     st.prefill_total))
            if st.prefilling:
                st.prefill_pos = max(st.prefill_pos, length)
        swapped_in = self.cache.swap_in(self._swap_in_fn, host_k, host_v,
                                        slot, length, shared)
        t_res = self._now(now)
        if self.tracer is not None:
            self._prog_note("swap_in", time.perf_counter() - w0,
                            swapped_in * self.cache.block_size
                            if self.prefix is not None else 0)
        if rt is not None:
            self.tracer.end(rt.swap_span, t=t_in0)
            rt.swap_span = None
            self.tracer.record("swap_in", t_in0, t_res, trace_id=rt.trace_id,
                               parent_id=rt.root, program="swap_in",
                               blocks=swapped_in, slot=slot)
            if st.result.tokens:
                rt.decode_span = self.tracer.begin(
                    "decode_segment", trace_id=rt.trace_id,
                    parent_id=rt.root, t=t_res, slot=slot, resumed=True)
        gap = max(t_res - rec.since, 0.0)
        st.result.preempted_wall += gap
        if st.result.tokens:
            # after the first token: left out of the TPOT span at finish (a
            # mid-prefill park fell before TTFT)
            st.result.decode_preempted_wall += gap
        st.order = self._admit_seq
        self._admit_seq += 1
        self._slots[slot] = st
        if self._adaptive is not None:
            self._adaptive.reset_slot(slot)
        self.swapped_blocks_in += swapped_in
        if self.telemetry is not None:
            reg = self.telemetry
            reg.counter("serving/swapped_blocks_in").inc(swapped_in)
            # the preempted interval is queue wait
            reg.histogram("serving/queue_wait_ms").observe(gap * 1e3)

    def step(self, now: Optional[float] = None) -> List[RequestResult]:
        """One serving iteration: the budgeted admit/prefill side (chunk
        continuations, admissions, preemptions), then one decode step for
        every decode-phase slot (slots still prefilling sit it out): a
        speculative one with ``speculative``. Returns requests finished."""
        if not self._warm:
            self.warmup()
        if now is None:
            now = self._time()
        self._last_step_now = now
        self._account_kv_occupancy(now)
        if self.slo is not None:
            # on the engine's clock: a virtual trace replays its alerts
            self.slo.maybe_evaluate(now)
        if self._pending_submit_stamps:
            # the first step after a context-carrying submit: its queue
            # wait starts here
            for rt in self._pending_submit_stamps:
                rt.submitted_t = now
            self._pending_submit_stamps.clear()
        finished: List[RequestResult] = []
        self._schedule(now, finished)
        active_slots = [i for i, s in enumerate(self._slots)
                        if s is not None and not s.prefilling]
        if not active_slots:
            # no decode ran: a later gap would fold idle time into the
            # TPOT guard's average
            self._last_decode_t = None
            return finished
        self._note_decode_gap()
        if self.spec is not None:
            return self._spec_step(now, active_slots, finished)
        return self._plain_step(now, active_slots, finished)

    def _account_kv_occupancy(self, now: float) -> None:
        """Bill each occupied slot's tenant for the KV it held since the
        last step: the pool blocks its table names (host numpy, no device
        read; a shared radix block bills every tenant that holds it), or
        slot-paged its whole row. On the engine's clock."""
        if self.tenants is None:
            return
        last = self._acct_last_t
        self._acct_last_t = now
        if last is None:
            return
        dt = now - last
        if dt <= 0:
            return
        paged = self.prefix is not None
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            blocks = int((self.cache.tables[i] != self.cache.sentinel).sum()) \
                if paged else 1
            self.tenants.note_kv_occupancy(st.tenant, blocks, dt,
                                           self._kv_bytes_per_block)

    def _context_rows(self, slots: List[int]) -> int:
        """K/V rows already cached for ``slots`` (a decode-phase slot holds
        its prompt and every emitted token but the last)."""
        return sum(len(self._slots[i].request.prompt)
                   + len(self._slots[i].result.tokens) - 1 for i in slots)

    def _iter_trace(self) -> str:
        """The engine's own trace, made at first use, for the iteration
        spans (decode, draft and verify steps)."""
        if self._engine_trace is None:
            self._engine_trace = self.tracer.new_trace()
        return self._engine_trace

    def _note_decode_gap(self) -> None:
        """Moving average of the host wall time between decode steps: the
        signal the ``tpot_slo_ms`` guard watches."""
        t = time.perf_counter()
        if self._last_decode_t is not None:
            gap = t - self._last_decode_t
            self._decode_gap_ema = gap if self._decode_gap_ema is None \
                else 0.7 * self._decode_gap_ema + 0.3 * gap
        self._last_decode_t = t

    def _plain_step(self, now: float, active_slots: List[int],
                    finished: List[RequestResult]) -> List[RequestResult]:
        """One token for every decode-phase slot (also the speculative
        step's fallback when nothing was drafted)."""
        # the previous step's read of its picks synchronized the stream, so
        # the pinned host buffers are free to write
        toks, active = self._toks_host.numpy(), self._active_host.numpy()
        toks.fill(self.pad_token_id)
        active.fill(False)
        for i in active_slots:
            toks[i] = self._slots[i].last_token
        active[active_slots] = True
        armed = self.tracer is not None
        if armed:
            t_dec0 = self._now(now)
        t0 = time.perf_counter()
        self._toks.copy_(self._toks_host, non_blocking=True)
        self._active.copy_(self._active_host, non_blocking=True)
        out = self._decode(self.engine.params, *self.cache.carry(),
                           *self.cache.decode_args(), self._toks,
                           self._active, self._temp, self._next_rng())
        self.cache.update(*out[:3])
        # the stream's one host read per step: the picks feed the streams
        nxt = out[3].cpu().numpy()
        dt = time.perf_counter() - t0
        self.decode_wall += dt
        if armed:
            # the token read above fences the step: an honest wall
            self._prog_note("decode", dt, self._context_rows(active_slots))
            self.tracer.record("decode_step", t_dec0, self._now(now),
                               trace_id=self._iter_trace(), program="decode",
                               n_slots=len(active_slots))
        self.decode_steps += 1
        self._active_slot_iterations += len(active_slots)
        self.tokens_generated += len(active_slots)
        if self.telemetry is not None:
            self.telemetry.counter("serving/decode_steps").inc()
            self.telemetry.counter("serving/slot_iterations_active").inc(
                len(active_slots))
        t_emit = self._now(now)
        for i in active_slots:
            st = self._slots[i]
            tok = int(nxt[i])
            st.result.tokens.append(tok)
            st.result.token_times.append(t_emit)
            st.result.decode_calls += 1
            st.last_token = tok
            if self.tenants is not None:
                self.tenants.note_tokens(st.tenant, 1)
            self._stream(st, [tok])
            done = self._maybe_finish(i, now)
            if done is not None:
                finished.append(done)
        return finished

    def _spec_step(self, now: float, active_slots: List[int],
                   finished: List[RequestResult]) -> List[RequestResult]:
        """One speculative iteration: draft up to k tokens per slot, verify
        them all in one target forward, emit each slot's accepted prefix
        plus one token (1 to draft_len + 1 tokens per slot). A slot's draft
        length is capped at its remaining budget - 1, so emission never
        overshoots max_new_tokens; the verify width is the smallest bucket
        holding the longest draft made; a round that drafted nothing runs
        the plain decode step. Slots in their prefill phase have no stream
        yet and sit the round out."""
        spec = self.spec
        nslots = self.num_slots
        want = np.zeros((nslots,), np.int32)
        for i in active_slots:
            st = self._slots[i]
            remaining = st.request.max_new_tokens - len(st.result.tokens)
            k_des = (self._adaptive.desired_k(i)
                     if self._adaptive is not None else spec.k_max)
            want[i] = max(0, min(k_des, remaining - 1))
        kb = pick_k_bucket(max(int(want.max()), 1), spec.k_buckets)
        # the drafters read each slot's stream: prompt + emitted tokens
        histories = [list(s.request.prompt) + s.result.tokens
                     if s is not None and not s.prefilling else None
                     for s in self._slots]
        armed = self.tracer is not None
        if armed:
            t_sp0 = self._now(now)
        t0 = time.perf_counter()
        drafts, lens = self._drafter.propose(histories, want, kb)
        lens = np.minimum(np.asarray(lens, np.int32), want)
        dt = time.perf_counter() - t0
        self._draft_wall += dt
        self.decode_wall += dt
        if armed:
            self.tracer.record("spec_draft", t_sp0, self._now(now),
                               trace_id=self._iter_trace(), k_bucket=kb,
                               n_slots=len(active_slots))
        longest = int(lens.max())
        if longest == 0:
            # nothing drafted anywhere: the plain step emits the same token
            return self._plain_step(now, active_slots, finished)
        kb = pick_k_bucket(longest, spec.k_buckets)
        self._verify_fn(kb)
        # the previous step's read synchronized the stream: the pinned
        # host buffers are free to write
        tokens = self._verify_tokens[kb][0].numpy()
        active = self._active_host.numpy()
        tokens.fill(self.pad_token_id)
        active.fill(False)
        for i in active_slots:
            tokens[i, 0] = self._slots[i].last_token
            n = int(lens[i])
            tokens[i, 1:1 + n] = drafts[i, :n]
        active[active_slots] = True
        self._draft_len_host.numpy()[:] = lens
        if armed:
            t_vf0 = self._now(now)
        t0 = time.perf_counter()
        out = self._verify_call(kb, self._next_rng())
        self.cache.update(*out[:3])
        # the step's one host read: accepted tokens and their counts
        out_tokens, n_emit = verify_to_host(out[3])
        dt = time.perf_counter() - t0
        self._verify_wall += dt
        self.decode_wall += dt
        if armed:
            self._prog_note(f"verify_{kb}", dt,
                            self._context_rows(active_slots))
            self.tracer.record("spec_verify", t_vf0, self._now(now),
                               trace_id=self._iter_trace(),
                               program=f"verify_{kb}",
                               n_slots=len(active_slots))
        self.decode_steps += 1
        self._active_slot_iterations += len(active_slots)
        reg = self.telemetry
        if reg is not None:
            reg.counter("serving/decode_steps").inc()
            reg.counter("serving/spec_verify_steps").inc()
            reg.counter("serving/slot_iterations_active").inc(
                len(active_slots))
        t_emit = self._now(now)
        for i in active_slots:
            st = self._slots[i]
            n = int(n_emit[i])
            emitted = [int(t) for t in out_tokens[i, :n]]
            n_drafted, n_accepted = int(lens[i]), n - 1
            if (self.eos_token_id is not None
                    and self.eos_token_id in emitted):
                # EOS inside the accepted block: the plain decode stops at
                # its first EOS, so the tokens behind it are dropped
                emitted = emitted[:emitted.index(self.eos_token_id) + 1]
            st.result.tokens.extend(emitted)
            st.result.token_times.extend([t_emit] * len(emitted))
            st.result.decode_calls += 1
            st.last_token = emitted[-1]
            self.tokens_generated += len(emitted)
            if self.tenants is not None:
                self.tenants.note_tokens(st.tenant, len(emitted))
            # only the accepted block is streamed
            self._stream(st, emitted)
            self.spec_drafted_tokens += n_drafted
            self.spec_accepted_tokens += n_accepted
            if self._adaptive is not None:
                self._adaptive.update(i, n_accepted, n_drafted)
            if reg is not None:
                reg.counter("serving/spec_drafted_tokens").inc(n_drafted)
                reg.counter("serving/spec_accepted_tokens").inc(n_accepted)
                reg.histogram("serving/accepted_tokens_per_step",
                              buckets=_TOKENS_PER_STEP_BUCKETS).observe(n)
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
        peak, the compile-once contract, batch fill, the swap buffer,
        block-paged the pool and prefix-cache gauges, and with speculation
        the acceptance rate, tokens per slot-step and the draft's share."""
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
        if self.swap is not None:
            reg.gauge("serving/swap_buffer_bytes").set(self.swap.bytes_stored)
            reg.gauge("serving/swap_buffer_peak_bytes").set(
                self.swap.peak_bytes)
            if self.swap.max_bytes is not None:
                reg.gauge("serving/swap_buffer_max_bytes").set(
                    self.swap.max_bytes)
        if self.prefix is not None:
            reg.gauge("serving/kv_pool_bytes").set(self.cache.hbm_bytes())
            reg.gauge("serving/kv_blocks_per_mib").set(
                self.cache.blocks_per_mib())
            reg.gauge("serving/prefix_hit_rate").set(self.prefix.hit_rate())
            reg.gauge("serving/prefix_pool_occupancy").set(
                self.cache.occupancy())
            reg.gauge("serving/prefix_cached_blocks").set(
                self.prefix.cached_blocks())
        if self.spec is not None:
            if self.spec_drafted_tokens:
                reg.gauge("serving/spec_acceptance_rate").set(
                    self.spec_accepted_tokens / self.spec_drafted_tokens)
            if self._active_slot_iterations:
                # decode-phase tokens per slot-step (1.0: the plain decode)
                reg.gauge("serving/spec_tokens_per_slot_step").set(
                    (self.tokens_generated - self.prefill_calls)
                    / self._active_slot_iterations)
            wall = self._draft_wall + self._verify_wall
            if wall > 0:
                # drafting's share of the draft + verify host wall
                reg.gauge("serving/spec_draft_overhead_frac").set(
                    self._draft_wall / wall)
