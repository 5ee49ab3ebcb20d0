"""Typed error hierarchy for the serving stack (copy of
deepspeed_tpu/serving/errors.py for the PyTorch port).

Every failure a caller can act on programmatically gets its own type:
admission-time request validation (bad prompt/budget shapes that used to
surface as downstream XLA shape or trace failures mid-step), host-swap
capacity pressure, and the fabric's traffic-layer conditions
(backpressure, deadlines, replica death). Two design rules:

  * **Compatibility** — request-validation errors subclass ``ValueError``
    and capacity errors subclass ``RuntimeError``, so pre-existing
    ``except ValueError`` call sites (and tests) keep working while new
    code can catch the precise type.
  * **Transient vs permanent** — the fabric router's retry policy keys
    on the TYPE, never on string matching: :class:`TransientReplicaError`
    is retryable (flaky step, failed probe), :class:`ReplicaCrashedError`
    means the replica is gone and in-flight work must fail over, and
    :class:`InvalidRequestError` is permanent (retrying the same request
    anywhere else would fail identically).
"""

from __future__ import annotations


class ServingError(Exception):
    """Base of every typed serving-stack error."""


# ----------------------------------------------- config / lifecycle / bugs
class EngineConfigError(ServingError, ValueError):
    """Construction-time misconfiguration of the engine, KV pools,
    scheduler, drafter, or fabric (bad buckets, dtypes, thresholds):
    permanent — no retry or admission order can serve it.  Subclasses
    ``ValueError`` so pre-typed ``except ValueError`` sites keep working."""


class KVLifecycleError(ServingError, ValueError):
    """KV block/swap lifecycle misuse by a caller: unpinning an unpinned
    block, freeing a pinned one, evicting an interior radix node, double
    preemption without a resume.  A programming error at the call site,
    not capacity pressure (subclasses ``ValueError`` — these sites
    predate the typed hierarchy and tests pin that family)."""


class EngineTypeError(ServingError, TypeError):
    """A serving-config argument of the wrong TYPE (vs. a bad value):
    subclasses ``TypeError`` so the stdlib convention — and any
    pre-typed ``except TypeError`` site — keeps holding."""


class EngineInvariantError(ServingError, RuntimeError):
    """An internal serving invariant broke — pool exhausted past the
    admission gate, a clock that stops advancing: an engine bug, not an
    operator or caller error (subclasses ``RuntimeError`` for
    compatibility with pre-typed call sites)."""


# --------------------------------------------------------- submit validation
class InvalidRequestError(ServingError, ValueError):
    """The request itself is malformed — permanent, never retried
    (subclasses ``ValueError`` for backward compatibility with the
    pre-typed ``ServingEngine.submit`` checks)."""


class EmptyPromptError(InvalidRequestError):
    """Submitted prompt has no tokens."""


class InvalidMaxNewTokensError(InvalidRequestError):
    """``max_new_tokens`` is not a positive integer."""


class PromptTooLongError(InvalidRequestError):
    """Prompt exceeds the largest prefill bucket and chunked prefill is
    off (set ``prefill_token_budget`` to serve it in chunks)."""


class SlotCapacityError(InvalidRequestError):
    """prompt + max_new_tokens (+ speculative lookahead) exceeds the
    per-slot KV capacity — no admission order could ever serve it."""


# ------------------------------------------------------------- host KV swap
class SwapCapacityError(ServingError, RuntimeError):
    """The host swap buffer's ``max_bytes`` cap would be exceeded: the
    preemption that wanted the space is declined instead of silently
    growing host memory."""


# ----------------------------------------------------------------- fabric
class FabricError(ServingError):
    """Base of the multi-replica fabric's traffic-layer errors."""


class RouterOverloadedError(FabricError):
    """Typed backpressure: the router's bounded queue is full and the
    submitted request is not higher-class than anything sheddable —
    the caller should slow down or retry later."""


class DeadlineExceededError(FabricError):
    """The request's deadline expired before it could be served (shed
    from the router queue before wasting prefill)."""


class NoHealthyReplicaError(FabricError):
    """Every replica is dead (or permanently abandoned by the
    supervisor's restart budget) — the fabric cannot make progress."""


class RetriesExhaustedError(FabricError):
    """The request failed more dispatch attempts than the router's
    retry budget allows."""


class ReplicaCrashedError(FabricError):
    """The replica died (process crash / preemption without grace).
    In-flight requests fail over to a survivor; the supervisor decides
    whether to resurrect the replica."""


class TransientReplicaError(FabricError):
    """A retryable replica-level hiccup (flaky step, failed health
    probe): the replica is still alive, the operation may be retried.
    Repeated transients trip the replica's circuit breaker."""


# ---------------------------------------------------------- elastic pool
class ReplicaAdmissionError(FabricError):
    """A joining replica failed its warm admission probe (or its name
    collides with a pool member): it never entered the dispatch set, so
    no request can have been routed to it — the scale-out is refused,
    the pool is unchanged, and the caller (typically the autoscaler)
    may retry with a fresh replica."""


class LastReplicaError(FabricError):
    """Refusing to remove the LAST healthy replica: a scale-down that
    empties the serving set would strand the queue forever — the
    autoscaler's ``min_replicas`` floor should have prevented the ask,
    and a manual drain of the final replica needs a replacement added
    first."""


class UnknownReplicaError(FabricError):
    """The named replica is not a member of the pool (never added, or
    already drained out) — a caller-side bookkeeping error, not a
    health condition."""
