"""Fault-tolerant request router over N serving replicas (port of
deepspeed_tpu/serving/fabric/router.py).

The traffic layer that turns one :class:`ServingEngine` into a service,
built with robustness as the headline — at scale replica failure is the
steady state, and the fabric must keep serving (and keep its SLOs)
through crashes, stragglers, and overload. Four pillars:

**Health-checked dispatch.** Periodic heartbeat probes feed per-replica
circuit breakers (fabric/health.py): ``failure_threshold`` consecutive
probe/step failures quarantine a replica (OPEN), a cooldown later one
half-open probe decides between full recovery and another quarantine
round. Placement is least-loaded over the healthy set, driven by the
serving signals a replica exposes (pending requests, free slots/blocks).

**Failover.** The router records every COMMITTED token per request (it
interposes on the engine's streaming callback), so when a replica dies
its in-flight requests are re-dispatched to a survivor by resubmitting
``prompt + committed_tokens`` with the remaining budget. Greedy decode
is a deterministic function of the context, and slot isolation makes a
request's tokens independent of its co-tenants — so in fp32 the merged
stream equals a fault-free run's; in bf16 on the card the resumed
request re-prefills its committed tokens where the uninterrupted run
wrote them by decode steps, so the continuation equals a fault-free
engine's run of ``prompt + committed`` (its own rounding), not always
the uninterrupted stream. Since the resumed request's committed tokens
ride in its PROMPT, nothing is ever re-streamed to the client (the
idempotency argument). Retries back off exponentially with
deterministic jitter; per-attempt timeouts re-dispatch work stuck on a
straggler (cancelling the stale copy so it cannot finish twice).
Crashed replicas are resurrected through a
:class:`~deepspeed_tpu_torch.serving.fabric.supervisor.ReplicaSupervisor`
(ElasticAgent-style rolling restart budget).

**Graceful degradation.** The router queue is bounded: overflow sheds
the lowest-priority queued request if the arrival outranks it,
otherwise the arrival is refused with a typed
:class:`RouterOverloadedError` (backpressure the caller can act on).
Requests whose deadline expires while queued are shed before they
waste prefill compute they can no longer use.

**Elastic pool.** The replica set is not fixed at construction:
:meth:`FabricRouter.add_replica` admits a newcomer after a warm health
probe (it wraps the SHARED InferenceEngine, so it reuses the weights and
programs; its warm-up captures the decode graph over its own KV store),
:meth:`FabricRouter.remove_replica` drains one out — no new dispatches,
in-flight work finishes or is re-dispatched from the committed-token
record at the drain deadline, so scale-down drops nothing. The
:class:`~deepspeed_tpu_torch.serving.fabric.autoscaler.ElasticAutoscaler`
drives both off SLO burn-rate alerts and load gauges.

**Chaos-tested.** Everything runs against in-process replicas in
virtual time; the scripted fault seams live in
``testing/fault_injection.py``, and the digital twin (fabric/twin.py)
drives full incident timelines with autoscaling in the loop.

The fabric catches only the typed replica errors
(:class:`ReplicaCrashedError`, :class:`TransientReplicaError`): a device
or graph-capture error inside a replica's step propagates, and is never
failed over as a crash.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, Optional, Sequence

from deepspeed_tpu_torch.elasticity.elastic_agent import backoff_delay
from deepspeed_tpu_torch.serving.errors import (EngineConfigError,
                                                EngineInvariantError,
                                                InvalidRequestError,
                                                LastReplicaError,
                                                NoHealthyReplicaError,
                                                ReplicaAdmissionError,
                                                ReplicaCrashedError,
                                                RouterOverloadedError,
                                                TransientReplicaError,
                                                UnknownReplicaError)
from deepspeed_tpu_torch.serving.fabric.health import (CLOSED, STATE_GAUGE,
                                                       CircuitBreaker)
from deepspeed_tpu_torch.serving.fabric.replica import Replica
from deepspeed_tpu_torch.serving.fabric.supervisor import ReplicaSupervisor
from deepspeed_tpu_torch.serving.scheduler import Request, RequestResult
from deepspeed_tpu_torch.utils.logging import log_dist

# breaker states 0..2 (health.STATE_GAUGE); the router extends the
# scale with its own terminal/parking states (draining/removed are the
# elastic-pool lifecycle states, past the health scale's ordering)
_STATE_RESTARTING = 3.0
_STATE_DEAD = 4.0
_STATE_DRAINING = 5.0
_STATE_REMOVED = 6.0


class _Tracked:
    """Router-side lifetime record of one request: the original
    request, the user's streaming callback, and every token the fabric
    has COMMITTED to the client — the failover unit. The committed
    list, not any replica's state, is the source of truth for resume:
    a dead replica's memory is unreachable by definition."""

    __slots__ = ("request", "user_cb", "committed", "committed_times",
                 "first_token_time", "retries", "failovers", "not_before",
                 "crash_t", "replica", "dispatch_t", "seq", "trace_id",
                 "root_span", "queued_t", "failover_span")

    def __init__(self, request: Request, seq: int):
        self.request = request
        self.user_cb = request.on_token
        self.committed: List[int] = []
        self.committed_times: List[float] = []
        self.first_token_time: Optional[float] = None
        self.retries = 0          # re-dispatches (first dispatch is free)
        self.failovers = 0        # re-dispatches caused by replica death
        self.not_before = 0.0     # retry backoff gate
        self.crash_t: Optional[float] = None   # failover-latency start
        self.replica: Optional[str] = None     # current assignment
        self.dispatch_t: Optional[float] = None
        self.seq = seq
        # span-graph context: the router owns the ROOT span
        # of every request it tracks; replica engines' spans link under
        # it via the trace fields _wrap() stamps on the engine-level
        # Request — so a failover's survivor spans land in the SAME
        # trace as the original attempt's
        self.trace_id: Optional[str] = None
        self.root_span = None            # open Span when tracing armed
        self.queued_t: float = 0.0       # router_queue span start
        self.failover_span = None        # open crash -> re-dispatch span


class FabricRouter:
    """Routes requests across replicas with health-checked dispatch,
    retry/backoff failover, load shedding, and supervised restarts.

    Parameters
    ----------
    replicas: the initial replica set (fabric/replica.py). Names must
        be unique; they key supervisor budgets and telemetry gauges.
    replica_factory: ``name -> Replica`` factory the router calls to
        resurrect a crashed replica (typically: fresh ServingEngine
        over the SHARED InferenceEngine, wrapped in InProcessReplica).
        Without it (or without a supervisor) a crashed replica stays
        dead and the fabric serves on with the survivors.
    supervisor: restart policy (rolling budget, backoff, restartable
        exits); None disables resurrection.
    max_queue: bound on the ROUTER queue (dispatched work queues inside
        its replica). Overflow sheds the worst lower-class queued
        request, else raises :class:`RouterOverloadedError`. None =
        unbounded.
    max_dispatch_depth: cap on one replica's unfinished requests before
        the router stops picking it as a target — keeps work shed-able
        in the router queue instead of buried in a replica backlog.
        None = dispatch eagerly.
    heartbeat_interval_s: virtual-time gap between probe rounds.
    failure_threshold / breaker_cooldown_s: circuit-breaker knobs.
    retry_max: max RE-dispatches per request before it fails with
        ``finish_reason="failed"``.
    retry_base_delay_s / retry_backoff_factor / retry_max_delay_s /
    retry_jitter: failover backoff schedule (jitter drawn from a
        seeded RNG — deterministic across runs).
    request_timeout_s: per-ATTEMPT timeout: an in-flight request with
        no finish after this long is cancelled on its replica and
        re-dispatched elsewhere (straggler mitigation). None disables.
    drain_timeout_s: default grace a draining replica gets to finish
        its in-flight work before the drain ESCALATES to failover
        (cancel + committed-token re-dispatch on a survivor, exactly
        the crash resume path — so even a timed-out drain drops
        nothing). None = wait indefinitely; ``remove_replica`` can
        override per call.
    time_fn: clock (virtual in tests); defaults to time.monotonic.
    telemetry: like ServingEngine — True = global registry, a
        MetricsRegistry = private, False/None = bare.
    tracer: span-graph tracer, or None (default) for
        untraced routing. Arm the REPLICA engines with the same tracer:
        the router owns each request's root span and stamps
        router-side spans (router_queue waits, per-replica dispatch
        attempts, failover gaps), while trace context propagated on the
        dispatched Request makes the engines' lifecycle spans — on
        whichever replica, across failovers — children of that same
        trace.
    slo: an :class:`~deepspeed_tpu_torch.telemetry.slo.SLOEngine`,
        evaluated once per fabric iteration on the ROUTER's clock —
        fabric-level SLIs (availability = non-failed finishes) judge
        crashes and shed storms the per-replica engines cannot see.
    flight_recorder: a
        :class:`~deepspeed_tpu_torch.telemetry.flight_recorder.FlightRecorder`
        the router triggers on its incident classes: replica crash,
        replica quarantine, and overload shed bursts
        (``shed_burst_threshold`` sheds within
        ``shed_burst_window_s``) — each trigger freezes the bounded
        pre-incident window into one postmortem JSON.
    """

    def __init__(self, replicas: Sequence[Replica], *,
                 replica_factory: Optional[Callable[[str], Replica]] = None,
                 supervisor: Optional[ReplicaSupervisor] = None,
                 max_queue: Optional[int] = None,
                 max_dispatch_depth: Optional[int] = None,
                 heartbeat_interval_s: float = 0.1,
                 failure_threshold: int = 3,
                 breaker_cooldown_s: float = 0.5,
                 retry_max: int = 5,
                 retry_base_delay_s: float = 0.02,
                 retry_backoff_factor: float = 2.0,
                 retry_max_delay_s: float = 1.0,
                 retry_jitter: float = 0.0,
                 request_timeout_s: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None,
                 time_fn: Optional[Callable[[], float]] = None,
                 telemetry=True, seed: int = 0, tracer=None,
                 slo=None, flight_recorder=None,
                 shed_burst_threshold: int = 4,
                 shed_burst_window_s: float = 1.0):
        if not replicas:
            raise EngineConfigError("fabric needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise EngineConfigError(f"duplicate replica names: {names}")
        self.replicas: Dict[str, Replica] = {r.name: r for r in replicas}
        self.replica_factory = replica_factory
        self.supervisor = supervisor
        self.max_queue = max_queue
        self.max_dispatch_depth = max_dispatch_depth
        self.heartbeat_interval_s = heartbeat_interval_s
        self.breakers: Dict[str, CircuitBreaker] = {
            n: CircuitBreaker(failure_threshold=failure_threshold,
                              cooldown_s=breaker_cooldown_s)
            for n in self.replicas}
        self._failure_threshold = failure_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self.retry_max = retry_max
        self.retry_base_delay_s = retry_base_delay_s
        self.retry_backoff_factor = retry_backoff_factor
        self.retry_max_delay_s = retry_max_delay_s
        self.retry_jitter = retry_jitter
        self.request_timeout_s = request_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self._rng = random.Random(seed)
        self._time = time_fn or time.monotonic
        self._real_clock = self._time in (time.monotonic, time.time,
                                          time.perf_counter)
        self._t0: Optional[float] = None
        self._last_hb = float("-inf")
        self._seq = 0
        self._queue: List[_Tracked] = []
        self._inflight: Dict[int, _Tracked] = {}
        # terminal results accumulated since the last step() drain
        # (sheds can happen inside submit(), between steps)
        self._done: List[RequestResult] = []
        self._restarting: Dict[str, float] = {}   # name -> resurrect-at
        self._dead: set = set()                   # permanently abandoned
        # elastic pool: draining members still step their
        # in-flight work but take no new dispatches; {"since": t,
        # "deadline": t|None} per name. Removed replicas leave every
        # dict — _retired_recompiles keeps their recompile history so
        # the zero-recompile pin survives pool churn.
        self._draining: Dict[str, dict] = {}
        self._retired_recompiles = 0
        self._next_replica_id = 0
        self.autoscaler = None                    # attach_autoscaler()
        # consecutive per-attempt timeouts per replica: a straggler's
        # steps SUCCEED (so the breaker's error path never sees it) —
        # failure_threshold strikes without a completion in between
        # trip the breaker explicitly
        self._timeout_strikes: Dict[str, int] = {}
        # fabric accounting (bench + tests read these directly)
        self.dispatches = 0
        self.failovers = 0
        self.retries = 0
        self.timeouts = 0
        self.shed_overload = 0
        self.shed_deadline = 0
        self.replica_crashes = 0
        self.replica_restarts = 0
        self.quarantines = 0
        self.completed = 0
        self.replicas_added = 0       # elastic scale-out admissions
        self.replicas_removed = 0     # elastic scale-in completions
        self.drain_redispatches = 0   # drain-timeout failovers
        if telemetry is True:
            from deepspeed_tpu_torch.telemetry import get_registry

            self.telemetry = get_registry()
        else:
            self.telemetry = telemetry or None
        self.tracer = tracer
        # ---- SLO control plane
        self.slo = slo
        if self.slo is not None and self.supervisor is not None:
            # fabric construction wires the alert fan-out:
            # the supervisor subscribes here, the autoscaler adds
            # itself on attach — no manual set_alert_callback dance,
            # and add_alert_callback is idempotent for re-wiring
            self.slo.add_alert_callback(self.supervisor.on_slo_alert)
        self.flight_recorder = flight_recorder
        self.shed_burst_threshold = shed_burst_threshold
        self.shed_burst_window_s = shed_burst_window_s
        self._recent_sheds: List[float] = []
        if self.telemetry is not None:
            from deepspeed_tpu_torch.telemetry.tenants import TenantLedger

            # router-side tenant ledger: sheds/failures happen BEFORE a
            # replica engine ever owns the request, so the engine-side
            # ledgers cannot see them (same registry — one bill)
            self.tenants = TenantLedger(self.telemetry)
        else:
            self.tenants = None
        log_dist(f"FabricRouter: replicas={names} max_queue={max_queue} "
                 f"hb={heartbeat_interval_s}s timeout={request_timeout_s}",
                 ranks=[0])

    # ------------------------------------------------------------- telemetry
    def _count(self, name: str, n: int = 1) -> None:
        if self.telemetry is not None:
            self.telemetry.counter(name).inc(n)

    def _gauge(self, name: str, v: float) -> None:
        if self.telemetry is not None:
            self.telemetry.gauge(name).set(v)

    def _observe(self, name: str, v: float) -> None:
        if self.telemetry is not None:
            self.telemetry.histogram(name).observe(v)

    def _state_gauge(self, name: str) -> None:
        if name in self._dead:
            v = _STATE_DEAD
        elif name in self._restarting:
            v = _STATE_RESTARTING
        elif name in self._draining:
            v = _STATE_DRAINING
        else:
            v = STATE_GAUGE[self.breakers[name].state]
        self._gauge(f"fabric/replica_state/{name}", v)

    def _pool_gauge(self) -> None:
        """``fabric/pool_size`` is SERVING capacity: alive members not
        on their way out (draining replicas finish work but take no new
        dispatches, so they are not capacity)."""
        self._gauge("fabric/pool_size",
                    sum(self._alive(n) and n not in self._draining
                        for n in self.replicas))

    # ----------------------------------------------------------------- clock
    def _now(self) -> float:
        if self._t0 is None:
            return 0.0
        return self._time() - self._t0

    # ----------------------------------------------------------------- queue
    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._inflight)

    def submit(self, request: Request, now: Optional[float] = None) -> None:
        """Enqueue a request, applying bounded-queue backpressure: when
        full, the worst STRICTLY-LOWER-class queued request is shed to
        make room (lowest priority class first);
        when the arrival itself is the worst, it is refused with
        :class:`RouterOverloadedError`. The raise is the typed
        backpressure signal; :meth:`run` converts it into a
        ``shed_overload`` result for trace replays."""
        now = self._now() if now is None else now
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            victim = None
            for tr in self._queue:
                if tr.request.priority <= request.priority:
                    continue      # equal-or-better class: not sheddable
                if victim is None \
                        or (tr.request.priority, tr.request.arrival_time,
                            tr.seq) > (victim.request.priority,
                                       victim.request.arrival_time,
                                       victim.seq):
                    victim = tr
            if victim is None:
                raise RouterOverloadedError(
                    f"router queue full ({self.max_queue}) and request "
                    f"{request.rid} (class {request.priority}) outranks "
                    f"nothing sheddable")
            self._queue.remove(victim)
            self._finish_shed(victim, now, "shed_overload")
        tr = _Tracked(request, self._seq)
        self._seq += 1
        if self.tracer is not None:
            # the router owns the root span: one trace per request for
            # its WHOLE fabric lifetime, failovers included
            root = self.tracer.begin(
                "request", t=request.arrival_time, rid=request.rid,
                priority=request.priority,
                prompt_len=len(request.prompt))
            tr.trace_id = root.trace_id
            tr.root_span = root
            tr.queued_t = max(request.arrival_time, 0.0)
        self._queue.append(tr)
        self._gauge("fabric/queue_depth", len(self._queue))

    def _finish_shed(self, tr: _Tracked, now: float, reason: str):
        """Emit a terminal non-served result (shed/failed/error)."""
        res = RequestResult(
            rid=tr.request.rid, prompt_len=len(tr.request.prompt),
            arrival_time=tr.request.arrival_time, finish_time=now,
            finish_reason=reason, priority=tr.request.priority,
            failovers=tr.failovers)
        res.tokens = list(tr.committed)
        res.token_times = list(tr.committed_times)
        if reason == "shed_overload":
            self.shed_overload += 1
            self._count("fabric/shed_requests")
            self._count("fabric/shed_overload")
        elif reason == "shed_deadline":
            self.shed_deadline += 1
            self._count("fabric/shed_requests")
            self._count("fabric/shed_deadline")
        elif reason == "rejected":
            self._count("fabric/rejected_requests")
        else:
            self._count("fabric/failed_requests")
        if self.tenants is not None and reason.startswith("shed"):
            self.tenants.note_shed(
                self.tenants.resolve(tr.request.tenant_id))
        if reason == "shed_overload":
            self._note_shed_burst(now)
        if self.tracer is not None and tr.root_span is not None:
            if tr.failover_span is None:
                # (same double-count guard as _dispatch: an open
                # failover span already covers this wait)
                self.tracer.record("router_queue", tr.queued_t, now,
                                   trace_id=tr.trace_id,
                                   parent_id=tr.root_span.span_id,
                                   outcome=reason)
            self.tracer.end(tr.failover_span, t=now, outcome=reason)
            tr.failover_span = None
            self.tracer.end(tr.root_span, t=now, finish_reason=reason,
                            failovers=tr.failovers)
        self._done.append(res)
        return res

    def _note_shed_burst(self, now: float) -> None:
        """Overload-shed burst detection: N overload sheds
        inside the trailing window is an INCIDENT, not background load
        shaping — freeze the flight recorder's pre-incident window. The
        shed list resets on trigger so one sustained storm produces one
        dump per threshold-crossing, not one per shed."""
        if self.flight_recorder is None:
            return
        self._recent_sheds.append(now)
        cutoff = now - self.shed_burst_window_s
        self._recent_sheds = [t for t in self._recent_sheds if t >= cutoff]
        if len(self._recent_sheds) >= self.shed_burst_threshold:
            n = len(self._recent_sheds)
            self._recent_sheds = []
            self.flight_recorder.trigger(
                "overload_shed_burst", t=now, sheds_in_window=n,
                window_s=self.shed_burst_window_s,
                queue_depth=len(self._queue))

    # ------------------------------------------------------------ iteration
    def step(self, now: Optional[float] = None) -> List[RequestResult]:
        """One fabric iteration: resurrect due replicas, heartbeat +
        breaker bookkeeping, shed expired deadlines, re-dispatch timed
        out attempts, dispatch the queue least-loaded, then advance
        every busy replica one serving iteration. Returns every
        request that reached a terminal state (served, shed, failed)."""
        if now is None:
            now = self._now()
        if self.slo is not None:
            # fabric-level SLO judgment on the router's clock
            self.slo.maybe_evaluate(now)
        self._maybe_resurrect(now)
        self._maybe_heartbeat(now)
        if self.autoscaler is not None:
            # scale decisions act on fresh health gauges, BEFORE this
            # step's dispatch — a scale-out admitted here takes work
            # this very iteration
            self.autoscaler.tick(now)
        self._shed_expired(now)
        self._check_timeouts(now)
        self._dispatch(now)
        self._step_replicas(now)
        self._advance_drains(now)
        done, self._done = self._done, []
        return done

    # ------------------------------------------------------- replica health
    def _alive(self, name: str) -> bool:
        return (name not in self._dead and name not in self._restarting
                and getattr(self.replicas[name], "alive", True))

    def _maybe_resurrect(self, now: float) -> None:
        for name, at in sorted(self._restarting.items()):
            if now < at or self.replica_factory is None:
                continue
            replica = self.replica_factory(name)
            self.replicas[name] = replica
            self.breakers[name] = CircuitBreaker(
                failure_threshold=self._failure_threshold,
                cooldown_s=self._breaker_cooldown_s)
            del self._restarting[name]
            self.replica_restarts += 1
            self._count("fabric/replica_restarts")
            self._state_gauge(name)
            log_dist(f"fabric: replica {name} resurrected at t={now:.3f}",
                     ranks=[0])

    def _maybe_heartbeat(self, now: float) -> None:
        if now - self._last_hb < self.heartbeat_interval_s:
            return
        self._last_hb = now
        for name in sorted(self.replicas):
            if not self._alive(name):
                self._state_gauge(name)
                continue
            breaker = self.breakers[name]
            if not breaker.allow_probe(now):
                self._state_gauge(name)
                continue
            self._count("fabric/heartbeats")
            try:
                health = self.replicas[name].probe(now)
            except ReplicaCrashedError:
                self._on_crash(name, now)
                continue
            except TransientReplicaError:
                self._count("fabric/probe_failures")
                if breaker.record_failure(now):
                    self._quarantine(name, now)
                self._state_gauge(name)
                continue
            was_open = breaker.state != CLOSED
            breaker.record_success(now)
            if was_open:
                self._count("fabric/breaker_recoveries")
            self._gauge(f"fabric/replica_load/{name}", health.load)
            self._gauge(f"fabric/replica_queue_depth/{name}",
                        health.queue_depth)
            self._gauge(f"fabric/replica_free_slots/{name}",
                        health.free_slots)
            if health.free_blocks is not None:
                self._gauge(f"fabric/replica_free_blocks/{name}",
                            health.free_blocks)
            self._state_gauge(name)
        self._gauge("fabric/healthy_replicas",
                    sum(self._alive(n) and n not in self._draining
                        and self.breakers[n].state == CLOSED
                        for n in self.replicas))
        # refresh the queue gauge on the periodic path too: dispatch
        # drains the queue without writing the gauge, so a submit-only
        # gauge reads stale-high forever once traffic goes idle (and a
        # gauge_ceiling SLI sampling it would never resolve its alert).
        self._gauge("fabric/queue_depth", len(self._queue))
        self._pool_gauge()

    def _quarantine(self, name: str, now: float) -> None:
        """The breaker tripped OPEN on a still-alive replica: stop
        dispatching to it and move its in-flight work to survivors —
        cancelling each request on the replica first, so the stale copy
        can never ALSO finish (the no-duplicates half of the failover
        idempotency argument)."""
        self.quarantines += 1
        self._count("fabric/quarantines")
        if self.flight_recorder is not None:
            self.flight_recorder.trigger(
                "replica_quarantine", replica=name, t=now,
                inflight=sum(tr.replica == name
                             for tr in self._inflight.values()))
        replica = self.replicas[name]
        for rid, tr in sorted(self._inflight.items()):
            if tr.replica != name:
                continue
            try:
                replica.cancel(rid)
            except ReplicaCrashedError:
                self._on_crash(name, now)   # requeues the rest too
                return
            self._requeue(tr, now, crashed=False)
        log_dist(f"fabric: replica {name} quarantined at t={now:.3f} "
                 f"({self.breakers[name]!r})", ranks=[0])

    def _on_crash(self, name: str, now: float) -> None:
        """Replica died: fail its in-flight requests over (committed-
        token resume), then ask the supervisor whether to resurrect."""
        self.replica_crashes += 1
        self._count("fabric/replica_crashes")
        if self.flight_recorder is not None:
            # the postmortem moment: freeze the pre-incident window
            # BEFORE failover mutates the in-flight picture
            self.flight_recorder.trigger(
                "replica_crash", replica=name, t=now,
                inflight=sorted(rid for rid, tr in self._inflight.items()
                                if tr.replica == name),
                tenants=sorted({(tr.request.tenant_id or "default")
                                for tr in self._inflight.values()
                                if tr.replica == name}))
        for rid, tr in sorted(self._inflight.items()):
            if tr.replica == name:
                self._requeue(tr, now, crashed=True)
        if name in self._draining:
            # a replica that dies MID-DRAIN was leaving anyway: its
            # in-flight work just failed over (above) — complete the
            # removal instead of asking the supervisor to resurrect
            # a member the pool no longer wants
            self._finalize_removal(name, now, outcome="crashed")
            return
        if self.supervisor is not None and self.replica_factory is not None:
            at = self.supervisor.on_failure(name, now)
        else:
            at = None
        if at is None:
            self._dead.add(name)
            self._count("fabric/replicas_abandoned")
        else:
            self._restarting[name] = at
        # the dead incarnation's straggler strikes die with it — a
        # resurrected replica starts clean (its breaker already does)
        self._timeout_strikes.pop(name, None)
        self._state_gauge(name)
        log_dist(f"fabric: replica {name} crashed at t={now:.3f}; "
                 + (f"restart at t={at:.3f}" if at is not None
                    else "abandoned"), ranks=[0])

    # -------------------------------------------------------- retry/failover
    def _retry_delay(self, k: int) -> float:
        return backoff_delay(k, base_s=self.retry_base_delay_s,
                             factor=self.retry_backoff_factor,
                             cap_s=self.retry_max_delay_s,
                             jitter=self.retry_jitter, rng=self._rng)

    def _requeue(self, tr: _Tracked, now: float, *, crashed: bool) -> None:
        """Return an in-flight request to the router queue for another
        attempt: committed tokens ride along (the resume context), the
        retry budget is charged, and backoff gates the re-dispatch."""
        self._inflight.pop(tr.request.rid, None)
        from_replica = tr.replica
        tr.replica = None
        tr.dispatch_t = None
        tr.retries += 1
        if crashed:
            tr.failovers += 1
            tr.crash_t = now
            self.failovers += 1
            self._count("fabric/failovers")
        if self.tracer is not None and tr.root_span is not None:
            tr.queued_t = now
            if crashed and tr.failover_span is None:
                # replica death -> re-dispatched on a survivor: its own
                # phase in the request's critical path (closed by the
                # next successful dispatch). The survivor's engine spans
                # join this SAME trace via _wrap's context fields.
                tr.failover_span = self.tracer.begin(
                    "failover", trace_id=tr.trace_id,
                    parent_id=tr.root_span.span_id, t=now,
                    from_replica=from_replica)
        if tr.retries > self.retry_max:
            self._finish_shed(tr, now, "failed")
            return
        self.retries += 1
        self._count("fabric/retries")
        tr.not_before = now + self._retry_delay(tr.retries)
        self._queue.append(tr)

    def _shed_expired(self, now: float) -> None:
        """Drop queued requests whose deadline already passed — before
        they waste prefill compute on an answer nobody is waiting for."""
        for tr in list(self._queue):
            dl = tr.request.deadline
            if dl is not None and now > dl:
                self._queue.remove(tr)
                self._finish_shed(tr, now, "shed_deadline")

    def _check_timeouts(self, now: float) -> None:
        """Per-attempt router-side timeout: cancel the stale copy on
        its (straggling) replica and re-dispatch elsewhere. The cancel
        MUST succeed before the request re-enters the queue — a copy
        we cannot cancel is a copy that could finish twice — so a
        cancel on a crashed replica degrades into the crash path."""
        if self.request_timeout_s is None:
            return
        for rid, tr in sorted(self._inflight.items()):
            if tr.dispatch_t is None \
                    or now - tr.dispatch_t <= self.request_timeout_s:
                continue
            name = tr.replica
            self.timeouts += 1
            self._count("fabric/timeouts")
            try:
                self.replicas[name].cancel(rid)
            except ReplicaCrashedError:
                self._on_crash(name, now)
                continue
            self._requeue(tr, now, crashed=False)
            # straggler detection: timeouts are the only signal a slow-
            # but-alive replica emits (its steps and probes all SUCCEED,
            # so the breaker's error path never fires). failure_threshold
            # consecutive strikes without a completed request in between
            # trip the breaker explicitly.
            strikes = self._timeout_strikes.get(name, 0) + 1
            self._timeout_strikes[name] = strikes
            if strikes >= self._failure_threshold:
                self._timeout_strikes[name] = 0
                self.breakers[name].trip(now)
                self._quarantine(name, now)

    # ---------------------------------------------------------- elastic pool
    @property
    def draining(self) -> List[str]:
        """Names currently draining out (sorted)."""
        return sorted(self._draining)

    def pool_size(self) -> int:
        """Serving capacity right now: alive, non-draining members."""
        return sum(self._alive(n) and n not in self._draining
                   for n in self.replicas)

    def add_replica(self, replica: Optional[Replica] = None, *,
                    name: Optional[str] = None,
                    now: Optional[float] = None,
                    warmup: bool = True) -> str:
        """Admit a replica into the pool (scale-out). With ``replica``
        None the router builds one through ``replica_factory`` —
        typically a fresh ServingEngine over the SHARED InferenceEngine,
        so the newcomer reuses its weights and programs (one entry per
        program: no recompile; its warm-up captures the decode graph over
        its own KV store). Admission is gated on a WARM health probe:
        the replica warms its programs and answers one probe before
        it can ever be a dispatch target; a failure refuses the whole
        scale-out with :class:`ReplicaAdmissionError` and leaves the
        pool untouched. An admitted replica inherits the fabric
        machinery cleanly — fresh circuit breaker, next heartbeat round
        probes it, supervisor restart budgets start unspent under its
        name. Returns the admitted name."""
        now = self._now() if now is None else now
        if replica is None:
            if self.replica_factory is None:
                raise EngineConfigError(
                    "add_replica() without a replica needs a "
                    "replica_factory")
            if name is None:
                while True:
                    name = f"scale-{self._next_replica_id}"
                    self._next_replica_id += 1
                    if name not in self.replicas:
                        break
            replica = self.replica_factory(name)
        else:
            if name is not None and name != replica.name:
                raise EngineConfigError(
                    f"name {name!r} != replica.name {replica.name!r}")
            name = replica.name
        if name in self.replicas:
            raise ReplicaAdmissionError(
                f"replica name {name!r} already in the pool "
                f"(state: {'dead' if name in self._dead else 'draining' if name in self._draining else 'restarting' if name in self._restarting else self.breakers[name].state})")
        try:
            if warmup:
                replica.warmup()
            health = replica.probe(now)
        except (ReplicaCrashedError, TransientReplicaError) as e:
            raise ReplicaAdmissionError(
                f"replica {name!r} failed its warm admission probe: "
                f"{e}") from e
        self.replicas[name] = replica
        self.breakers[name] = CircuitBreaker(
            failure_threshold=self._failure_threshold,
            cooldown_s=self._breaker_cooldown_s)
        self.replicas_added += 1
        self._count("fabric/replicas_added")
        if self.telemetry is not None:
            self.telemetry.event(
                "fabric/replica_added", replica=name, t=now,
                pool_size=self.pool_size(),
                probe_free_slots=health.free_slots,
                probe_queue_depth=health.queue_depth)
        self._state_gauge(name)
        self._pool_gauge()
        log_dist(f"fabric: replica {name} admitted at t={now:.3f} "
                 f"(pool={self.pool_size()})", ranks=[0])
        return name

    def remove_replica(self, name: str, *, drain: bool = True,
                       drain_timeout_s: Optional[float] = ...,
                       now: Optional[float] = None) -> None:
        """Retire a replica (scale-in). ``drain=True`` (the default)
        is graceful: the member immediately stops receiving dispatches
        but keeps stepping its in-flight requests to completion; once
        empty (or at the drain deadline, when every leftover is
        cancelled and re-dispatched on a survivor via the committed-
        token resume path) it leaves the pool. ``drain=False`` skips
        the grace entirely — cancel + re-dispatch now. Either way no
        request is ever dropped by a scale-down. Removing the LAST
        healthy replica is refused with :class:`LastReplicaError`;
        an unknown name raises :class:`UnknownReplicaError`; repeating
        a remove on an already-draining member is a no-op."""
        now = self._now() if now is None else now
        if name not in self.replicas:
            raise UnknownReplicaError(
                f"replica {name!r} is not a pool member "
                f"(members: {sorted(self.replicas)})")
        if name in self._draining:
            return   # idempotent: the drain is already underway
        if self._alive(name):
            others = [n for n in self.replicas
                      if n != name and self._alive(n)
                      and n not in self._draining]
            if not others:
                raise LastReplicaError(
                    f"refusing to remove {name!r}: it is the last "
                    f"healthy replica (add a replacement first)")
        if drain_timeout_s is ...:
            drain_timeout_s = self.drain_timeout_s
        deadline = None
        if not drain:
            deadline = now
        elif drain_timeout_s is not None:
            deadline = now + drain_timeout_s
        self._draining[name] = {"since": now, "deadline": deadline}
        inflight = sum(tr.replica == name
                       for tr in self._inflight.values())
        if self.telemetry is not None:
            self.telemetry.event(
                "fabric/replica_draining", replica=name, t=now,
                inflight=inflight, drain=drain,
                deadline=deadline)
        self._state_gauge(name)
        self._pool_gauge()
        log_dist(f"fabric: replica {name} draining at t={now:.3f} "
                 f"(inflight={inflight}, deadline={deadline})", ranks=[0])
        # an empty drain (or drain=False) completes synchronously —
        # callers see the member gone on return
        self._advance_drains(now)

    def _advance_drains(self, now: float) -> None:
        """Drive every in-progress drain one notch: finalize the empty
        ones, escalate the expired ones (cancel each straggler on the
        draining member, then re-dispatch it from the router's
        committed-token record — the cancel MUST succeed first, same
        no-duplicates argument as the timeout path)."""
        for name in sorted(self._draining):
            if name not in self._draining:
                continue   # a crash escalation below finalized it
            if not self._alive(name):
                # died (or was abandoned) before remove_replica was
                # called on it: nothing in flight, just bookkeeping
                self._finalize_removal(name, now, outcome="dead")
                continue
            inflight = sorted(
                (tr for tr in self._inflight.values()
                 if tr.replica == name),
                key=lambda tr: tr.request.rid)
            if not inflight:
                self._finalize_removal(name, now, outcome="drained")
                continue
            deadline = self._draining[name]["deadline"]
            if deadline is None or now < deadline:
                continue   # grace period still running
            replica = self.replicas[name]
            crashed = False
            for tr in inflight:
                try:
                    replica.cancel(tr.request.rid)
                except ReplicaCrashedError:
                    # degrade into the crash path: it requeues the
                    # rest AND finalizes the removal (draining branch)
                    self._on_crash(name, now)
                    crashed = True
                    break
                self.drain_redispatches += 1
                self._count("fabric/drain_redispatches")
                self._requeue(tr, now, crashed=False)
            if not crashed:
                self._finalize_removal(name, now, outcome="timeout")

    def _finalize_removal(self, name: str, now: float, *,
                          outcome: str) -> None:
        """The replica leaves every router structure. Its recompile
        history is retired into a cumulative counter so the fabric-wide
        zero-recompile pin survives pool churn, and the replica is released
        (an in-process one drops its engine: its KV store and decode graphs
        leave the card)."""
        info = self._draining.pop(name, None)
        replica = self.replicas.pop(name, None)
        self.breakers.pop(name, None)
        self._restarting.pop(name, None)
        self._dead.discard(name)
        self._timeout_strikes.pop(name, None)
        if replica is not None:
            try:
                self._retired_recompiles += replica.recompile_count()
            except ReplicaCrashedError:
                pass   # a remote incarnation's counters died with it
            replica.release()
        duration_ms = None
        if info is not None:
            duration_ms = max(now - info["since"], 0.0) * 1e3
            self._observe("fabric/drain_duration_ms", duration_ms)
        self.replicas_removed += 1
        self._count("fabric/replicas_removed")
        if self.telemetry is not None:
            self.telemetry.event(
                "fabric/replica_removed", replica=name, t=now,
                outcome=outcome, duration_ms=duration_ms,
                pool_size=self.pool_size())
        self._gauge(f"fabric/replica_state/{name}", _STATE_REMOVED)
        self._pool_gauge()
        log_dist(f"fabric: replica {name} removed at t={now:.3f} "
                 f"({outcome}, pool={self.pool_size()})", ranks=[0])

    def attach_autoscaler(self, autoscaler) -> None:
        """Wire an :class:`ElasticAutoscaler`: ticked once per fabric
        iteration (on the router's clock, before dispatch) and — when
        an SLO engine is present — subscribed to its alert fan-out."""
        self.autoscaler = autoscaler
        if self.slo is not None:
            self.slo.add_alert_callback(autoscaler.on_slo_alert)

    # --------------------------------------------------------------- dispatch
    def _dispatch_targets(self) -> List[str]:
        out = []
        for name in sorted(self.replicas):
            if name in self._draining:
                continue   # a draining member finishes, it never receives
            if not self._alive(name) or not self.breakers[name].dispatchable:
                continue
            if self.max_dispatch_depth is not None and \
                    self.replicas[name].pending >= self.max_dispatch_depth:
                continue
            out.append(name)
        return out

    def _dispatch(self, now: float) -> None:
        if not self._queue:
            return
        if (not self._restarting
                and all(not getattr(r, "alive", True) or n in self._dead
                        for n, r in self.replicas.items())):
            # every replica is permanently gone: nothing will ever be
            # served again — fail the backlog loudly instead of
            # spinning forever
            err = NoHealthyReplicaError("all replicas dead/abandoned")
            for tr in list(self._queue):
                self._queue.remove(tr)
                self._finish_shed(tr, now, "failed")
                log_dist(f"fabric: {err}: failing request "
                         f"{tr.request.rid}", ranks=[0])
            return
        ready = sorted(
            (tr for tr in self._queue
             if tr.request.arrival_time <= now and tr.not_before <= now),
            key=lambda tr: (tr.request.priority, tr.request.arrival_time,
                            tr.seq))
        for tr in ready:
            targets = self._dispatch_targets()
            if not targets:
                break
            name = min(targets,
                       key=lambda n: (self.replicas[n].pending, n))
            try:
                self.replicas[name].submit(self._wrap(tr))
            except InvalidRequestError as e:
                # permanent: the request would fail identically anywhere
                self._queue.remove(tr)
                self._finish_shed(tr, now, "rejected")
                log_dist(f"fabric: request {tr.request.rid} rejected: {e}",
                         ranks=[0])
                continue
            except ReplicaCrashedError:
                self._on_crash(name, now)
                continue
            except TransientReplicaError:
                if self.breakers[name].record_failure(now):
                    self._quarantine(name, now)
                continue
            self._queue.remove(tr)
            self._inflight[tr.request.rid] = tr
            tr.replica = name
            tr.dispatch_t = now
            self.dispatches += 1
            self._count("fabric/dispatches")
            if self.tracer is not None and tr.root_span is not None:
                if tr.failover_span is None:
                    self.tracer.record(
                        "router_queue", tr.queued_t, now,
                        trace_id=tr.trace_id,
                        parent_id=tr.root_span.span_id,
                        replica=name, attempt=tr.retries + 1)
                else:
                    # a crash-requeued attempt's wait IS the failover
                    # span (crash -> re-dispatch): a router_queue span
                    # over the same interval would double-count the
                    # queue phase. Keep the replica/attempt attrs on a
                    # zero-length marker at the dispatch instant so the
                    # attempt sequence stays reconstructable.
                    self.tracer.record(
                        "router_queue", now, now,
                        trace_id=tr.trace_id,
                        parent_id=tr.root_span.span_id,
                        replica=name, attempt=tr.retries + 1)
                self.tracer.end(tr.failover_span, t=now, to_replica=name)
                tr.failover_span = None
            if tr.crash_t is not None:
                # failover latency: replica death -> work back on a
                # healthy replica (detection + backoff + placement)
                self._observe("fabric/failover_latency_ms",
                              max(now - tr.crash_t, 0.0) * 1e3)
                tr.crash_t = None

    def _wrap(self, tr: _Tracked) -> Request:
        """The engine-level request for the CURRENT attempt: original
        prompt + every committed token as the prompt (so a resumed
        request re-prefills its own history and continues exactly where
        the stream left off), remaining budget, and the router's
        committing callback interposed before the user's.

        The resumed prompt is LONGER than the original by the committed
        count — prompt + max_new always fit the slot (that sum is
        invariant), but on engines WITHOUT chunked prefill a resume can
        outgrow the largest prefill bucket and be rejected; size
        buckets to max_len (or enable prefill_token_budget) on fabric
        replicas."""
        base = tr.request

        def on_token(tok: int, _tr=tr) -> None:
            self._commit(_tr, tok)

        return Request(
            rid=base.rid,
            prompt=list(base.prompt) + list(tr.committed),
            max_new_tokens=base.max_new_tokens - len(tr.committed),
            arrival_time=base.arrival_time, priority=base.priority,
            on_token=on_token, deadline=base.deadline,
            tenant_id=base.tenant_id,
            # trace context: every attempt — original or failover
            # re-dispatch — carries the SAME trace id, parented under
            # the router's root span, so the whole multi-replica
            # lifecycle reconstructs as one graph
            trace_id=tr.trace_id,
            parent_span=(tr.root_span.span_id
                         if tr.root_span is not None else None))

    def _commit(self, tr: _Tracked, tok: int) -> None:
        now = self._now()
        tr.committed.append(tok)
        tr.committed_times.append(now)
        if tr.first_token_time is None:
            tr.first_token_time = now
        if tr.user_cb is not None:
            tr.user_cb(tok)

    # ----------------------------------------------------------------- step
    def _step_replicas(self, now: float) -> None:
        for name in sorted(self.replicas):
            if not self._alive(name):
                continue
            replica = self.replicas[name]
            if not any(tr.replica == name for tr in self._inflight.values()):
                continue
            breaker = self.breakers[name]
            try:
                results = replica.step(now)
            except ReplicaCrashedError:
                self._on_crash(name, now)
                continue
            except TransientReplicaError:
                self._count("fabric/transient_errors")
                if breaker.record_failure(now):
                    self._quarantine(name, now)
                continue
            breaker.record_success(now)
            for res in results:
                self._finalize(res, now)

    def _finalize(self, res: RequestResult, now: float) -> None:
        tr = self._inflight.pop(res.rid, None)
        if tr is None:
            return   # cancelled concurrently (should not happen in-process)
        # splice the fabric view over the final attempt's result: the
        # committed stream IS the full token sequence (prior attempts'
        # tokens rode in this attempt's prompt and never re-streamed)
        res.tokens = list(tr.committed)
        res.token_times = list(tr.committed_times)
        res.prompt_len = len(tr.request.prompt)
        if tr.first_token_time is not None:
            res.first_token_time = tr.first_token_time
        res.priority = tr.request.priority
        res.failovers = tr.failovers
        res.replica = tr.replica or ""
        if tr.replica:
            # a completion is real progress: the replica is not stuck
            self._timeout_strikes[tr.replica] = 0
        if res.finish_reason == "shed_deadline":
            # the ENGINE shed it at admission (deadline expired while
            # queued inside the replica, past the router's own check):
            # account it as a shed, not a completion
            self.shed_deadline += 1
            self._count("fabric/shed_requests")
            self._count("fabric/shed_deadline")
        else:
            self.completed += 1
            self._count("fabric/completed_requests")
        if self.tracer is not None and tr.root_span is not None:
            self.tracer.end(tr.root_span, t=now,
                            finish_reason=res.finish_reason,
                            replica=res.replica, failovers=tr.failovers,
                            tokens=len(res.tokens))
        self._done.append(res)

    def _rebase_clock(self) -> None:
        """Anchor the offset clock at 'now' for a (re)starting run().
        Every stored instant — breaker cooldown anchors, pending
        restarts, retry gates, in-flight dispatch stamps, supervisor
        restart windows — is expressed in run-relative offsets, so a
        SECOND run() on the same router must shift them into the new
        base or heartbeats/cooldowns would stall for the length of the
        previous trace (and the very first heartbeat must fire
        immediately)."""
        new_t0 = self._time()
        if self._t0 is not None:
            shift = new_t0 - self._t0
            for b in self.breakers.values():
                if b.opened_at is not None:
                    b.opened_at -= shift
            self._restarting = {n: at - shift
                                for n, at in self._restarting.items()}
            self._draining = {
                n: {"since": d["since"] - shift,
                    "deadline": (None if d["deadline"] is None
                                 else d["deadline"] - shift)}
                for n, d in self._draining.items()}
            for tr in self._queue:
                tr.not_before -= shift
            for tr in list(self._queue) + list(self._inflight.values()):
                if tr.dispatch_t is not None:
                    tr.dispatch_t -= shift
                if tr.crash_t is not None:
                    tr.crash_t -= shift
                tr.queued_t -= shift
                if tr.root_span is not None:
                    tr.root_span.start -= shift
                if tr.failover_span is not None:
                    tr.failover_span.start -= shift
            if self.supervisor is not None:
                self.supervisor.rebase(shift)
        self._last_hb = float("-inf")
        self._t0 = new_t0

    # ------------------------------------------------------------------ run
    def run(self, requests: Sequence[Request], *,
            warmup: bool = True) -> List[RequestResult]:
        """Serve a trace to completion across the fabric.
        ``arrival_time``s are offsets from run() start. Overflow
        backpressure (:class:`RouterOverloadedError`) is converted into
        ``shed_overload`` results so trace replays account for every
        request; direct :meth:`submit` callers get the raise instead."""
        if warmup:
            for name in sorted(self.replicas):
                if self._alive(name):
                    self.replicas[name].warmup()
        future = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
        self._rebase_clock()
        out: List[RequestResult] = []
        i = 0
        stall = 0
        while i < len(future) or self._queue or self._inflight:
            now = self._time() - self._t0
            while i < len(future) and future[i].arrival_time <= now:
                try:
                    self.submit(future[i], now=now)
                except RouterOverloadedError:
                    tr = _Tracked(future[i], self._seq)
                    self._seq += 1
                    self._finish_shed(tr, now, "shed_overload")
                i += 1
            before = len(out)
            out.extend(self.step(now))
            progressed = len(out) > before or bool(self._inflight)
            if not progressed and self._real_clock:
                time.sleep(0.001)
            stall = 0 if progressed else stall + 1
            if stall > 10_000_000:
                raise EngineInvariantError(
                    "fabric clock is not advancing toward the next "
                    "arrival/retry/restart (non-monotonic time_fn?)")
        out.extend(self._done)   # sheds emitted after the last step drain
        self._done = []
        if self.telemetry is not None:
            self._gauge("fabric/queue_depth", 0)
            self._gauge("fabric/completed_total", self.completed)
            self.telemetry.flush()
        return out

    # ------------------------------------------------------------- inspection
    def recompile_count(self) -> int:
        """Sum of post-warmup recompiles across the LIVING replica set
        plus every retired member's history (the chaos suites pin this
        at zero — crash/failover/resume/scale churn must never change a
        compiled program's operand signature)."""
        return self._retired_recompiles + sum(
            self.replicas[n].recompile_count()
            for n in self.replicas if self._alive(n))

    def __repr__(self):
        states = {n: ("dead" if n in self._dead else
                      "restarting" if n in self._restarting else
                      "draining" if n in self._draining else
                      self.breakers[n].state)
                  for n in sorted(self.replicas)}
        return (f"FabricRouter(replicas={states}, queue={len(self._queue)}, "
                f"inflight={len(self._inflight)})")
