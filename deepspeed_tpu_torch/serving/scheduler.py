"""Iteration-level (continuous-batching) request scheduler (port of
deepspeed_tpu/serving/scheduler.py: ``Request``, ``RequestResult``,
``pick_bucket``, ``SlotScheduler``, ``poisson_trace``).

Orca-style: the unit of scheduling is one decode iteration. Between decode
steps waiting requests are admitted into free slots, so a drained slot is
refilled at once instead of idling until a static batch's straggler ends.
Priority classes: lower ``priority`` runs sooner, FIFO within a class,
optional aging so no class starves. Pure host-side policy."""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple


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
    prefill_chunks: int = 0

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival_time

    @property
    def first_token_latency(self) -> float:
        return self.first_token_time - self.arrival_time

    @property
    def queue_wait(self) -> float:
        return max(self.admitted_time - self.arrival_time, 0.0)


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

    def submit(self, request: Request) -> None:
        q = self._queues.setdefault(request.priority, deque())
        q.append((self._seq, request))
        self._seq += 1

    @property
    def waiting(self) -> int:
        return sum(len(q) for q in self._queues.values())

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

    def admit(self, now: float,
              limit: Optional[int] = None) -> List[Tuple[Request, int]]:
        """Pop (request, slot) pairs: arrived requests into free slots,
        best effective priority first, FIFO within a class; ``limit`` caps
        the admissions of one call."""
        out: List[Tuple[Request, int]] = []
        while self._free and (limit is None or len(out) < limit):
            head = self._best_head(now)
            if head is None:
                break
            q, _seq, req = head
            q.popleft()
            if not q:
                del self._queues[req.priority]
            out.append((req, self._free.popleft()))
        return out

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
