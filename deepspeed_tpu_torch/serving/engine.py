"""Continuous-batching serving engine of the PyTorch port (port of the
slot-paged greedy path of deepspeed_tpu/serving/engine.py).

Between decode iterations the scheduler admits waiting requests into free
slots of the persistent slot cache (serving/kv_slots.py); each admission
prefills its prompt in the smallest bucket that holds it (batch 1, padded),
and every iteration decodes one token for all slots at a fixed width with a
per-slot length vector. A request's tokens are bit-identical whether it runs
alone or beside other slots: every op of the decode step is row-wise and the
bucket padding sits causally after the true last prompt position.

Options the JAX engine has and this port does not yet (prefix cache,
speculative decoding, preemption, chunked prefill, tracing, SLO control,
tenants, quantized KV, sampling) raise :class:`EngineConfigError`; the
``telemetry`` argument is accepted and ignored.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.serving.errors import (EmptyPromptError,
                                                EngineConfigError,
                                                EngineInvariantError,
                                                InvalidMaxNewTokensError,
                                                PromptTooLongError,
                                                SlotCapacityError)
from deepspeed_tpu_torch.serving.kv_slots import SlotKVCache
from deepspeed_tpu_torch.serving.scheduler import (Request, RequestResult,
                                                   SlotScheduler, pick_bucket)
from deepspeed_tpu_torch.utils.logging import log_dist

_NOT_PORTED = ("prefix_cache", "speculative", "preemption",
               "prefill_token_budget", "tracer", "slo", "tenants", "kv_dtype",
               "do_sample")


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
    """

    def __init__(self, engine, *, num_slots: int = 8, max_len: int = 1024,
                 buckets: Sequence[int] = (128, 512, 2048),
                 eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                 time_fn: Optional[Callable[[], float]] = None,
                 telemetry=True, priority_aging_sec: Optional[float] = None,
                 prefix_cache: bool = False, speculative=None,
                 preemption: Optional[str] = None,
                 prefill_token_budget: Optional[int] = None, tracer=None,
                 slo=None, tenants: Optional[bool] = None,
                 kv_dtype: Optional[str] = None, do_sample: bool = False):
        requested = {"prefix_cache": prefix_cache,
                     "speculative": speculative not in (None, "off"),
                     "preemption": preemption, "prefill_token_budget":
                     prefill_token_budget, "tracer": tracer, "slo": slo,
                     "tenants": tenants, "kv_dtype": kv_dtype not in (
                         None, "bf16", "compute"), "do_sample": do_sample}
        for name in _NOT_PORTED:
            if requested[name]:
                raise EngineConfigError(
                    f"ServingEngine option {name}={requested[name]!r} is not "
                    "ported to the PyTorch engine yet (slot-paged greedy "
                    "serving only)")
        self.engine = engine
        mcfg = engine.module.config
        if max_len > mcfg.max_seq_len:
            raise EngineConfigError(
                f"serving max_len {max_len} exceeds the model's max_seq_len "
                f"{mcfg.max_seq_len} (position table size)")
        self.cache = SlotKVCache(engine.module, num_slots, max_len,
                                 dtype=engine.dtype, device=engine.device)
        self.buckets = tuple(sorted({min(b, max_len) for b in buckets}))
        if not self.buckets:
            raise EngineConfigError(f"no prefill buckets given: {buckets}")
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.device = engine.device
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
        self._decode = engine.slot_decode_program(num_slots, max_len,
                                                  pad_token_id=pad_token_id)
        self.decode_steps = 0
        self.decode_wall = 0.0
        log_dist(f"ServingEngine: slots={num_slots} max_len={max_len} "
                 f"buckets={self.buckets} cache={self.cache!r}", ranks=[0])

    # ---------------------------------------------------------- programs
    def _prefill_fn(self, bucket: int):
        if bucket not in self._prefill:
            self._prefill[bucket] = self.engine.slot_prefill_program(
                bucket, self.num_slots, self.max_len)
        return self._prefill[bucket]

    def warmup(self) -> None:
        """Run every bucket's prefill and the decode step once on dummy
        data (this builds the CUDA kernels and warms the libraries), then
        reset the slot lengths."""
        if self._warm:
            return
        params = self.engine.params
        for b in self.buckets:
            ids = torch.zeros((1, b), dtype=torch.long, device=self.device)
            out = self._prefill_fn(b)(params, *self.cache.carry(), ids, 0, 1)
            self.cache.update(*out[:3])
        toks = torch.zeros((self.num_slots,), dtype=torch.int32,
                           device=self.device)
        active = torch.zeros((self.num_slots,), dtype=torch.bool,
                             device=self.device)
        out = self._decode(params, *self.cache.carry(), toks, active)
        self.cache.update(*out[:3])
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
        return st.result

    def _maybe_finish(self, slot: int, now: float) -> Optional[RequestResult]:
        st = self._slots[slot]
        if (self.eos_token_id is not None and st.result.tokens
                and st.result.tokens[-1] == self.eos_token_id):
            return self._finish(slot, now, "eos")
        if len(st.result.tokens) >= st.request.max_new_tokens:
            return self._finish(slot, now, "length")
        return None

    @staticmethod
    def _stream(st: _SlotState, tokens) -> None:
        cb = st.request.on_token
        if cb is not None:
            for t in tokens:
                cb(int(t))

    def _admit_one(self, slot: int, req: Request, now: float,
                   finished: List[RequestResult]) -> None:
        """Admit one request into ``slot``: shed it if its deadline passed,
        else prefill the whole prompt in its bucket and commit the first
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
            return
        st = _SlotState(req, res, last_token=0)
        self._slots[slot] = st
        bucket = pick_bucket(plen, self.buckets)
        ids = np.full((1, bucket), self.pad_token_id, np.int64)
        ids[0, :plen] = np.asarray(req.prompt, np.int64)
        out = self._prefill_fn(bucket)(
            self.engine.params, *self.cache.carry(),
            torch.from_numpy(ids).to(self.device), slot, plen)
        self.cache.update(*out[:3])
        tok = int(out[3])          # the token must reach the host stream
        res.prefill_chunks += 1
        st.last_token = tok
        res.tokens.append(tok)
        t_emit = self._now(now)
        res.first_token_time = t_emit
        res.token_times.append(t_emit)
        self._stream(st, [tok])
        done = self._maybe_finish(slot, now)
        if done is not None:
            finished.append(done)

    def _schedule(self, now: float, finished: List[RequestResult]) -> None:
        while True:
            pairs = self.scheduler.admit(now, limit=1)
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
        toks = np.full((self.num_slots,), self.pad_token_id, np.int32)
        for i in active_slots:
            toks[i] = self._slots[i].last_token
        active = np.zeros((self.num_slots,), bool)
        active[active_slots] = True
        t0 = time.perf_counter()
        out = self._decode(self.engine.params, *self.cache.carry(),
                           torch.from_numpy(toks).to(self.device),
                           torch.from_numpy(active).to(self.device))
        self.cache.update(*out[:3])
        nxt = out[3].cpu().numpy()   # decode's picks feed the host streams
        self.decode_wall += time.perf_counter() - t0
        self.decode_steps += 1
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
        return results
