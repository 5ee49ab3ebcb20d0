"""Iteration-level (continuous-batching) request scheduler (port of
deepspeed_tpu/serving/scheduler.py: ``Request``, ``RequestResult``,
``pick_bucket``, ``SlotScheduler`` and the trace generators).

Orca-style: the unit of scheduling is one decode iteration. Between decode
steps waiting requests are admitted into free slots, so a drained slot is
refilled at once instead of idling until a static batch's straggler ends.
Priority classes: lower ``priority`` runs sooner, FIFO within a class,
optional aging so no class starves. Pure host-side policy."""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.serving.errors import EngineConfigError


@dataclasses.dataclass
class Request:
    """One generation request in the serving queue."""

    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    arrival_time: float = 0.0
    # scheduling class: lower = more latency-critical (0 = default)
    priority: int = 0
    # invoked once per committed token, in emission order
    on_token: Optional[Callable[[int], None]] = dataclasses.field(
        default=None, repr=False, compare=False)
    # absolute completion deadline in the engine clock, or None; a request
    # whose deadline passed before admission is shed without prefill
    deadline: Optional[float] = None
    # the tenant whose bill the request lands on (telemetry/tenants.py);
    # None is the default tenant. Sanitized before it names metrics
    tenant_id: Optional[str] = None
    # trace context (telemetry/spans.py): set by whoever owns the request's
    # root span. A request that arrives with a trace id keeps it, and the
    # engine's spans link under ``parent_span``; None with an armed tracer:
    # the engine opens a fresh trace and owns its root span
    trace_id: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)
    parent_span: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)


@dataclasses.dataclass
class RequestResult:
    """Completed request + latency accounting (times in the engine's clock,
    same base as Request.arrival_time)."""

    rid: int
    prompt_len: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    arrival_time: float = 0.0
    admitted_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    finish_reason: str = ""  # "eos" | "length" | "shed_deadline"
    # decode-step invocations that included this request
    decode_calls: int = 0
    priority: int = 0
    # engine-clock time of every committed token (token_times[0] is TTFT's)
    token_times: List[float] = dataclasses.field(default_factory=list)
    # prefill program calls the prompt took (1 = monolithic)
    prefill_chunks: int = 0
    # times swapped out, and the time spent off the slot set (swap-out to
    # swap-in): queue wait, not decode latency. The part after the first
    # token (decode_preempted_wall) is left out of the engine's TPOT; a
    # park during the chunked prefill falls before TTFT.
    preemptions: int = 0
    preempted_wall: float = 0.0
    decode_preempted_wall: float = 0.0
    # fabric accounting: times the request failed over to a surviving
    # replica after a crash, and the replica that finished it. The
    # fabric's terminal states add "shed_overload" | "rejected" | "failed"
    failovers: int = 0
    replica: str = ""

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival_time

    @property
    def first_token_latency(self) -> float:
        return self.first_token_time - self.arrival_time

    @property
    def queue_wait(self) -> float:
        """Time runnable but not running: the initial wait plus every
        preempted interval (a preempted request is back in the queue)."""
        return (max(self.admitted_time - self.arrival_time, 0.0)
                + self.preempted_wall)


def pick_bucket(prompt_len: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest prefill bucket (ascending) that fits the prompt, or None."""
    for b in buckets:
        if prompt_len <= b:
            return b
    return None


class SlotScheduler:
    """Priority-class iteration-level scheduler over a fixed slot set.

    Invariants (as in the JAX package): a slot is free or holds one
    request and is admissible again right after release(); FIFO within a
    class; across classes the best effective priority
    ``priority - waiting / aging_sec`` wins; admit() never admits a future
    arrival and never over-fills."""

    def __init__(self, num_slots: int, *, aging_sec: Optional[float] = None):
        self.num_slots = num_slots
        self.aging_sec = aging_sec
        self._free: deque = deque(range(num_slots))
        self._queues: Dict[int, deque] = {}   # class -> deque[(seq, Request)]
        self._seq = 0
        # rid -> original submission seq, kept after admission so that a
        # preempted request's resubmit restores its exact position
        self._seq_of: Dict[int, int] = {}
        self.admissions_per_slot = [0] * num_slots
        self.peak_queue_depth = 0

    def submit(self, request: Request) -> None:
        q = self._queues.setdefault(request.priority, deque())
        q.append((self._seq, request))
        self._seq_of[request.rid] = self._seq
        self._seq += 1
        self.peak_queue_depth = max(self.peak_queue_depth, self.waiting)

    def resubmit(self, request: Request) -> None:
        """Re-queue a preempted request under its original submission
        sequence, at its original place in its class (ahead of every
        same-class entry first submitted after it, equal-arrival bursts
        included): a swap-out costs compute, never queue position."""
        seq = self._seq_of.get(request.rid)
        if seq is None:          # never submitted here
            seq = self._seq
            self._seq_of[request.rid] = seq
            self._seq += 1
        q = self._queues.setdefault(request.priority, deque())
        items = list(q)
        i = 0
        while i < len(items) and ((items[i][1].arrival_time, items[i][0])
                                  < (request.arrival_time, seq)):
            i += 1
        items.insert(i, (seq, request))
        self._queues[request.priority] = deque(items)
        self.peak_queue_depth = max(self.peak_queue_depth, self.waiting)

    @property
    def waiting(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def next_arrival(self) -> Optional[float]:
        """Earliest arrival over the class heads (the next instant admit()
        could take anything)."""
        heads = [q[0][1].arrival_time for q in self._queues.values() if q]
        return min(heads) if heads else None

    def effective_priority(self, req: Request, now: float) -> float:
        if not self.aging_sec:
            return float(req.priority)
        return req.priority - max(now - req.arrival_time, 0.0) / self.aging_sec

    def _best_head(self, now: float):
        best = None
        for q in self._queues.values():
            if not q:
                continue
            seq, req = q[0]
            if req.arrival_time > now:
                continue
            key = (self.effective_priority(req, now), req.priority,
                   req.arrival_time, seq)
            if best is None or key < best[0]:
                best = (key, q, seq, req)
        return best[1:] if best is not None else None

    def peek(self, now: float) -> Optional[Request]:
        """The request admit() would take next (arrived class heads only):
        preemption compares its class with the running slots'."""
        head = self._best_head(now)
        return head[2] if head is not None else None

    def admit(self, now: float, fits: Optional[Callable[[Request], bool]] = None,
              limit: Optional[int] = None) -> List[Tuple[Request, int]]:
        """Pop (request, slot) pairs: arrived requests into free slots,
        best effective priority first, FIFO within a class; ``limit`` caps
        the admissions of one call.

        ``fits(request)`` gates admission on a resource the scheduler does
        not own (the block-paged engine's free pool blocks). A best head
        that does not fit blocks everything behind it, so no later arrival
        jumps the queue on block luck."""
        out: List[Tuple[Request, int]] = []
        while self._free and (limit is None or len(out) < limit):
            head = self._best_head(now)
            if head is None:
                break
            q, _seq, req = head
            if fits is not None and not fits(req):
                break
            q.popleft()
            if not q:
                del self._queues[req.priority]
            slot = self._free.popleft()
            self.admissions_per_slot[slot] += 1
            out.append((req, slot))
        return out

    def remove(self, rid: int) -> bool:
        """Withdraw a waiting request (the engine's cancel). False when
        ``rid`` is not queued; slots are the engine's to free."""
        for pri, q in list(self._queues.items()):
            for i, (_seq, req) in enumerate(q):
                if req.rid == rid:
                    del q[i]
                    if not q:
                        del self._queues[pri]
                    return True
        return False

    def release(self, slot: int) -> None:
        assert slot not in self._free, f"slot {slot} double-released"
        self._free.append(slot)


def poisson_trace(rng, n_requests: int, *, rate: float,
                  prompt_lens: Sequence[int],
                  max_new_choices: Sequence[int],
                  vocab_size: int, start_rid: int = 0) -> List[Request]:
    """Mixed-length Poisson arrival trace: exponential inter-arrival gaps at
    ``rate`` requests/s, prompt lengths and output budgets drawn uniformly
    from the given choice sets. ``rng`` is a numpy RandomState, so a trace
    is the same for the JAX package and the port given the same seed."""
    reqs: List[Request] = []
    t = 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate)) if rate > 0 else 0.0
        plen = int(rng.choice(list(prompt_lens)))
        reqs.append(Request(
            rid=start_rid + i,
            prompt=rng.randint(0, vocab_size, size=plen).astype("int32")
                      .tolist(),
            max_new_tokens=int(rng.choice(list(max_new_choices))),
            arrival_time=t))
    return reqs


def shared_prefix_trace(rng, n_requests: int, *, rate: float,
                        prefix_len: int, suffix_lens: Sequence[int],
                        max_new_tokens: int, vocab_size: int,
                        n_prefixes: int = 2,
                        start_rid: int = 0) -> List[Request]:
    """Shared-prefix trace for prefix caching: every prompt is one of
    ``n_prefixes`` shared system prompts of ``prefix_len`` tokens (drawn per
    request) followed by a unique suffix whose length is drawn from
    ``suffix_lens``. Poisson arrivals like :func:`poisson_trace`; the same
    numpy RandomState draws as the JAX package's, so a seed gives both the
    same trace."""
    prefixes = [rng.randint(0, vocab_size, size=prefix_len).tolist()
                for _ in range(max(n_prefixes, 1))]
    reqs: List[Request] = []
    t = 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate)) if rate > 0 else 0.0
        slen = int(rng.choice(list(suffix_lens)))
        suffix = rng.randint(0, vocab_size, size=slen).tolist()
        reqs.append(Request(
            rid=start_rid + i,
            prompt=prefixes[int(rng.randint(len(prefixes)))] + suffix,
            max_new_tokens=max_new_tokens,
            arrival_time=t))
    return reqs


def templated_trace(rng, n_requests: int, *, rate: float,
                    pattern_len: int, repeats: int,
                    max_new_tokens: int, vocab_size: int,
                    n_templates: int = 4,
                    start_rid: int = 0) -> List[Request]:
    """Templated trace: each prompt is one of ``n_templates`` random
    ``pattern_len``-token n-grams repeated ``repeats`` times (form letters,
    code stubs: the traffic prompt-lookup drafting finds continuations in).
    Poisson arrivals like :func:`poisson_trace`."""
    patterns = [rng.randint(0, vocab_size, size=pattern_len).tolist()
                for _ in range(max(n_templates, 1))]
    reqs: List[Request] = []
    t = 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate)) if rate > 0 else 0.0
        reqs.append(Request(
            rid=start_rid + i,
            prompt=patterns[int(rng.randint(len(patterns)))] * repeats,
            max_new_tokens=max_new_tokens,
            arrival_time=t))
    return reqs


def _rand_prompt(rng, plen: int, vocab_size: int) -> List[int]:
    return rng.randint(0, vocab_size, size=int(plen)).astype("int32").tolist()


def bursty_poisson_trace(rng, n_requests: int, *, burst_size: int,
                         burst_rate: float, prompt_lens: Sequence[int],
                         max_new_choices: Sequence[int], vocab_size: int,
                         priorities: Sequence[int] = (0,),
                         start_rid: int = 0) -> List[Request]:
    """Bursty trace: burst start times are Poisson at ``burst_rate``
    bursts/s and each burst lands ``burst_size`` requests at one instant
    (the flash-crowd shape); prompt lengths, output budgets and priority
    classes are drawn per request from their choice sets."""
    reqs: List[Request] = []
    t = 0.0
    while len(reqs) < n_requests:
        t += float(rng.exponential(1.0 / burst_rate)) if burst_rate > 0 \
            else 0.0
        for _ in range(min(burst_size, n_requests - len(reqs))):
            reqs.append(Request(
                rid=start_rid + len(reqs),
                prompt=_rand_prompt(rng, rng.choice(list(prompt_lens)),
                                    vocab_size),
                max_new_tokens=int(rng.choice(list(max_new_choices))),
                arrival_time=t,
                priority=int(rng.choice(list(priorities)))))
    return reqs


def bimodal_trace(rng, n_requests: int, *, rate: float,
                  short_lens: Sequence[int], long_lens: Sequence[int],
                  long_frac: float, short_new: Sequence[int],
                  long_new: Sequence[int], vocab_size: int,
                  short_priority: int = 0, long_priority: int = 1,
                  start_rid: int = 0) -> List[Request]:
    """Bimodal trace: mostly short prompts at the latency-critical class,
    a ``long_frac`` share of long prompts at a lower class (the mix where
    a monolithic long prefill stalls every decoding request). Poisson
    arrivals at ``rate`` requests/s like :func:`poisson_trace`."""
    reqs: List[Request] = []
    t = 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate)) if rate > 0 else 0.0
        long = bool(rng.rand() < long_frac)
        reqs.append(Request(
            rid=start_rid + i,
            prompt=_rand_prompt(
                rng, rng.choice(list(long_lens if long else short_lens)),
                vocab_size),
            max_new_tokens=int(rng.choice(
                list(long_new if long else short_new))),
            arrival_time=t,
            priority=long_priority if long else short_priority))
    return reqs


def straggler_trace(rng, n_requests: int, *, rate: float,
                    prompt_lens: Sequence[int],
                    max_new_choices: Sequence[int],
                    straggler_every: int, straggler_prompt_len: int,
                    straggler_max_new: int, vocab_size: int,
                    straggler_priority: int = 1,
                    start_rid: int = 0) -> List[Request]:
    """Short traffic with a long-context straggler every
    ``straggler_every``-th request (``straggler_prompt_len`` prompt,
    ``straggler_max_new`` outputs, a lower class). Poisson arrivals at
    ``rate`` like :func:`poisson_trace`."""
    if straggler_every < 1:
        raise EngineConfigError(f"straggler_every must be >= 1, "
                                f"got {straggler_every}")
    reqs: List[Request] = []
    t = 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate)) if rate > 0 else 0.0
        if (i + 1) % straggler_every == 0:
            reqs.append(Request(
                rid=start_rid + i,
                prompt=_rand_prompt(rng, straggler_prompt_len, vocab_size),
                max_new_tokens=straggler_max_new,
                arrival_time=t, priority=straggler_priority))
        else:
            reqs.append(Request(
                rid=start_rid + i,
                prompt=_rand_prompt(rng, rng.choice(list(prompt_lens)),
                                    vocab_size),
                max_new_tokens=int(rng.choice(list(max_new_choices))),
                arrival_time=t))
    return reqs
