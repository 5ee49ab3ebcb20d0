"""SLO-alert-driven elastic autoscaler for the serving fabric (port of
deepspeed_tpu/serving/fabric/autoscaler.py).

Closes the telemetry->action loop: the burn-rate
alerts (telemetry/slo.py) and the router's load gauges become BOUNDED
scale decisions against the elastic replica pool
(:meth:`FabricRouter.add_replica` / :meth:`FabricRouter.remove_replica`).
The policy is deliberately conservative — in an autoscaler the failure
mode is not "too slow", it is THRASH, and every guard here exists to
make thrash impossible by construction:

  * **Hysteresis** — separate up/down signals. Scale-OUT wants a
    page-severity burn alert, a queue past ``queue_high``, or overload
    sheds this tick; scale-IN wants the opposite extreme — zero queue,
    zero sheds, NO firing alert of any severity — held continuously
    for ``idle_stable_s``. The wide dead band between the two means
    alert flapping (or an injected alert storm) oscillates inside it
    without ever reversing a decision.
  * **Cooldowns** — ``scale_out_cooldown_s`` / ``scale_in_cooldown_s``
    gate consecutive decisions in the SAME direction; scale-in is slow
    by default (10x) because shrinking too eagerly re-triggers the
    very overload that just scaled us up.
  * **Rolling scale budget** — a
    :class:`~deepspeed_tpu_torch.elasticity.elastic_agent.RollingWindowBudget`
    (the elastic agent's restart-budget semantics, reused) caps TOTAL
    decisions inside the trailing window, so even a pathological
    signal source degrades to "pool frozen + suppressed counter", not
    to churn.
  * **Hard bounds** — ``min_replicas`` / ``max_replicas``; the floor
    also keeps the router's :class:`LastReplicaError` unreachable in
    normal operation.

Every decision (and every admission failure) is emitted as a typed
``fabric/autoscale`` event carrying its full evidence — queue depth,
shed delta, the firing rule names, pool before/after, budget spent —
so a twin run's JSONL replays the WHY of each scale, not just the
when. Suppressed wants bump ``fabric/autoscale_suppressed`` without
event spam.

The autoscaler is host-only and clock-agnostic: it is ticked by
:meth:`FabricRouter.step` on the router's (possibly virtual) clock and
subscribed to the SLO engine's alert fan-out by
:meth:`FabricRouter.attach_autoscaler`, so a FakeClock twin run
replays its decision timeline bit-identically.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.elasticity.elastic_agent import RollingWindowBudget
from deepspeed_tpu_torch.serving.errors import (EngineConfigError,
                                                FabricError,
                                                ReplicaAdmissionError)
from deepspeed_tpu_torch.utils.logging import log_dist


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One autoscaler decision, with the evidence that justified it."""

    action: str          # "scale_out" | "scale_in" | "scale_out_failed"
    t: float
    reason: str          # "page_burn" | "queue_pressure" | "shed" | "idle"
    replica: Optional[str]   # admitted / draining member (None on failure)
    pool_before: int
    pool_after: int
    evidence: Dict       # queue_depth, shed_delta, firing rules, budget


class ElasticAutoscaler:
    """Turns SLO alerts + router load into bounded pool-size changes.

    Parameters
    ----------
    router: the :class:`FabricRouter` to scale. Construction wires both
        directions: the router ticks the autoscaler each iteration and
        (when it carries an SLO engine) subscribes
        :meth:`on_slo_alert` to the alert fan-out.
    min_replicas / max_replicas: hard pool bounds.
    scale_out_cooldown_s / scale_in_cooldown_s: minimum gap between
        decisions in the same direction.
    queue_high: router queue depth at/above which scale-out is wanted
        even without an alert (the alert windows trail reality by
        design; the queue is the leading indicator).
    queue_low: queue depth at/below which the pool counts as idle
        (the scale-in side of the hysteresis band).
    idle_stable_s: how long the idle condition must hold CONTINUOUSLY
        before a scale-in fires.
    max_scale_events / scale_window_s: the rolling decision budget —
        at most ``max_scale_events`` decisions inside any trailing
        ``scale_window_s`` window.
    warn_scales_out: whether warn-severity burn alerts (not just page)
        also request scale-out. Off by default: warns are slow-burn
        trends, and queue pressure covers the real ones.
    """

    def __init__(self, router, *,
                 min_replicas: int = 1,
                 max_replicas: int = 8,
                 scale_out_cooldown_s: float = 1.0,
                 scale_in_cooldown_s: float = 10.0,
                 queue_high: int = 8,
                 queue_low: int = 0,
                 idle_stable_s: float = 5.0,
                 max_scale_events: int = 6,
                 scale_window_s: float = 60.0,
                 warn_scales_out: bool = False):
        if min_replicas < 1:
            raise EngineConfigError(
                f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise EngineConfigError(
                f"max_replicas {max_replicas} < min_replicas "
                f"{min_replicas}")
        if queue_low >= queue_high:
            raise EngineConfigError(
                f"hysteresis band is empty: queue_low {queue_low} >= "
                f"queue_high {queue_high}")
        self.router = router
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.scale_out_cooldown_s = scale_out_cooldown_s
        self.scale_in_cooldown_s = scale_in_cooldown_s
        self.queue_high = queue_high
        self.queue_low = queue_low
        self.idle_stable_s = idle_stable_s
        self.warn_scales_out = warn_scales_out
        self.budget = RollingWindowBudget(
            max_scale_events, scale_window_s,
            time_fn=lambda: self._now)
        self._now = 0.0              # budget reads the last tick instant
        self._firing_pages: set = set()
        self._firing_warns: set = set()
        self._last_out = float("-inf")
        self._last_in = float("-inf")
        self._idle_since: Optional[float] = None
        self._last_sheds = router.shed_overload + router.shed_deadline
        self.decisions: List[ScaleDecision] = []
        self.suppressed = 0          # wants blocked by cooldown/budget
        self.alerts_seen = 0
        router.attach_autoscaler(self)

    # ----------------------------------------------------------- alert seam
    def on_slo_alert(self, alert) -> None:
        """Subscriber on the SLO engine's fan-out: track which rules
        are CURRENTLY firing, by severity. Exception-free by
        construction (set ops only) — and the fan-out would contain a
        failure anyway."""
        self.alerts_seen += 1
        bucket = (self._firing_pages if alert.severity == "page"
                  else self._firing_warns)
        if alert.kind == "fired":
            bucket.add(alert.rule)
        else:
            bucket.discard(alert.rule)

    # ----------------------------------------------------------------- tick
    def tick(self, now: float) -> Optional[ScaleDecision]:
        """One policy evaluation on the router's clock (called by
        :meth:`FabricRouter.step` before dispatch). At most one
        decision per tick."""
        self._now = now
        router = self.router
        queue_depth = len(router._queue)
        sheds = router.shed_overload + router.shed_deadline
        shed_delta = sheds - self._last_sheds
        self._last_sheds = sheds
        pool = router.pool_size()

        want_out, reason = None, None
        if self._firing_pages:
            want_out, reason = True, "page_burn"
        elif self.warn_scales_out and self._firing_warns:
            want_out, reason = True, "warn_burn"
        elif shed_delta > 0:
            want_out, reason = True, "shed"
        elif queue_depth >= self.queue_high:
            want_out, reason = True, "queue_pressure"

        if want_out:
            self._idle_since = None   # pressure resets the idle run
            if pool >= self.max_replicas:
                return None           # at the ceiling: nothing to do
            if now - self._last_out < self.scale_out_cooldown_s \
                    or self.budget.spent(now) >= self.budget.max_events:
                self.suppressed += 1
                self._count("fabric/autoscale_suppressed")
                return None
            return self._scale_out(now, reason, queue_depth, shed_delta)

        idle = (queue_depth <= self.queue_low and shed_delta == 0
                and not self._firing_pages and not self._firing_warns)
        if not idle:
            self._idle_since = None
            return None
        if self._idle_since is None:
            self._idle_since = now
        if pool <= self.min_replicas:
            return None
        if now - self._idle_since < self.idle_stable_s:
            return None
        if now - self._last_in < self.scale_in_cooldown_s \
                or self.budget.spent(now) >= self.budget.max_events:
            self.suppressed += 1
            self._count("fabric/autoscale_suppressed")
            return None
        return self._scale_in(now, queue_depth)

    # ------------------------------------------------------------- actions
    def _scale_out(self, now: float, reason: str, queue_depth: int,
                   shed_delta: int) -> ScaleDecision:
        pool = self.router.pool_size()
        try:
            name = self.router.add_replica(now=now)
            action = "scale_out"
        except (ReplicaAdmissionError, EngineConfigError) as e:
            # refused admission (failed warm probe / no factory): the
            # pool is unchanged — record the attempt with its error so
            # the twin report shows WHY capacity never arrived, and
            # charge the budget (a crashing admission loop must not
            # retry unboundedly)
            name, action = None, "scale_out_failed"
            log_dist(f"autoscaler: scale-out failed at t={now:.3f}: {e}",
                     ranks=[0])
        self.budget.record(now)
        self._last_out = now
        return self._decide(
            action, now, reason, name, pool, queue_depth=queue_depth,
            shed_delta=shed_delta)

    def _scale_in(self, now: float, queue_depth: int) -> Optional[ScaleDecision]:
        router = self.router
        pool = router.pool_size()
        candidates = [n for n in router.replicas
                      if router._alive(n) and n not in router._draining]
        if len(candidates) <= self.min_replicas:
            return None
        # victim: least loaded; ties broken by name DESCENDING so the
        # most recently admitted scale-N members leave first and the
        # seed pool is shrunk last
        victim = max(candidates,
                     key=lambda n: (-router.replicas[n].pending, n))
        try:
            router.remove_replica(victim, drain=True, now=now)
        except FabricError as e:
            log_dist(f"autoscaler: scale-in refused at t={now:.3f}: {e}",
                     ranks=[0])
            return None
        self.budget.record(now)
        self._last_in = now
        self._idle_since = now   # a fresh stability window per decision
        return self._decide(
            "scale_in", now, "idle", victim, pool,
            queue_depth=queue_depth, shed_delta=0)

    def _decide(self, action: str, now: float, reason: str,
                replica: Optional[str], pool_before: int,
                **signals) -> ScaleDecision:
        evidence = dict(
            signals, firing_pages=sorted(self._firing_pages),
            firing_warns=sorted(self._firing_warns),
            budget_spent=self.budget.spent(now))
        decision = ScaleDecision(
            action=action, t=now, reason=reason, replica=replica,
            pool_before=pool_before,
            pool_after=self.router.pool_size(), evidence=evidence)
        self.decisions.append(decision)
        if action == "scale_out":
            self._count("fabric/autoscale_out")
        elif action == "scale_in":
            self._count("fabric/autoscale_in")
        else:
            self._count("fabric/autoscale_failed")
        reg = self.router.telemetry
        if reg is not None:
            reg.event("fabric/autoscale", action=action, t=now,
                      reason=reason, replica=replica,
                      pool_before=pool_before,
                      pool_after=decision.pool_after, **evidence)
        log_dist(f"autoscaler: {action} ({reason}) at t={now:.3f} "
                 f"pool {pool_before}->{decision.pool_after} "
                 f"replica={replica}", ranks=[0])
        return decision

    def _count(self, name: str) -> None:
        if self.router.telemetry is not None:
            self.router.telemetry.counter(name).inc()

    def __repr__(self):
        return (f"ElasticAutoscaler(pool={self.router.pool_size()}, "
                f"bounds=[{self.min_replicas},{self.max_replicas}], "
                f"decisions={len(self.decisions)}, "
                f"suppressed={self.suppressed}, "
                f"firing={sorted(self._firing_pages | self._firing_warns)})")
