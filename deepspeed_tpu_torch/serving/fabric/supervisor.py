"""Replica supervisor — ElasticAgent semantics for the serving fabric
(port of deepspeed_tpu/serving/fabric/supervisor.py).

:class:`~deepspeed_tpu_torch.elasticity.elastic_agent.ElasticAgent` owns a
worker group's whole lifecycle in a blocking ``run()`` loop; the fabric
router instead needs an EVENT-DRIVEN supervisor it can consult from its
serving loop: "replica r1 just crashed at t=4.2 — may it be resurrected,
and when?". This class re-implements the agent's fault-tolerance policy
(see elasticity/elastic_agent.py) in that shape, per replica:

* **Rolling restart budget** — only restarts inside the trailing
  ``restart_window_s`` count against ``max_restarts``; a replica that
  crashed twice last week is not one crash from abandonment today.
* **Exponential backoff + jitter** — consecutive crashes back off
  ``restart_delay_s * backoff_factor**k`` (capped), with deterministic
  jitter from an injectable RNG so a rack of replicas doesn't
  re-register in lockstep.
* **Restartable exits** — a preemption-style exit (infrastructure
  churn, not a sick replica) restarts without burning budget and resets
  the failure backoff, with its own escalating delay and a generous
  ``max_preemption_restarts`` cap against a persistent signal
  hot-looping the fabric.

All decisions are pure functions of the caller's clock — the chaos
suite drives scripted crash schedules through it in virtual time with
:class:`~deepspeed_tpu_torch.testing.fault_injection.FakeClock`, mirroring
the ElasticAgent tests on the training side.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from deepspeed_tpu_torch.elasticity.elastic_agent import backoff_delay
from deepspeed_tpu_torch.utils.logging import logger


class _ReplicaRecord:
    __slots__ = ("restart_times", "consecutive", "consecutive_preemptions",
                 "last_failure_t", "abandoned", "restarts",
                 "preemption_restarts")

    def __init__(self):
        self.restart_times: List[float] = []
        self.consecutive = 0
        self.consecutive_preemptions = 0
        self.last_failure_t: Optional[float] = None
        self.abandoned = False
        self.restarts = 0
        self.preemption_restarts = 0


class ReplicaSupervisor:
    """Decides, per crashed replica, whether and when to resurrect it.

    :meth:`on_failure` returns the earliest (caller-clock) instant the
    replica may be respawned, or ``None`` when the budget is spent and
    the replica is permanently abandoned — the router then serves on
    with the survivors (degraded capacity beats a crash loop eating the
    fabric's cycles)."""

    def __init__(self, *, max_restarts: int = 3,
                 restart_window_s: Optional[float] = None,
                 restart_delay_s: float = 0.5,
                 max_restart_delay_s: float = 30.0,
                 backoff_factor: float = 2.0, jitter: float = 0.0,
                 max_preemption_restarts: int = 100,
                 rng: Optional[random.Random] = None, tracer=None):
        self.max_restarts = max_restarts
        self.restart_window_s = restart_window_s
        self.restart_delay_s = restart_delay_s
        self.max_restart_delay_s = max_restart_delay_s
        self.backoff_factor = backoff_factor
        self.jitter = jitter
        self.max_preemption_restarts = max_preemption_restarts
        self._rng = rng or random.Random(0)
        self._records: Dict[str, _ReplicaRecord] = {}
        # span-graph tracer: each restart decision is one
        # closed span (failure instant -> earliest respawn instant) on a
        # supervisor-scope trace, so fabric downtime windows line up
        # next to the request traces in the Chrome-trace export
        self.tracer = tracer
        self._trace: Optional[str] = None
        # SLO alert subscription: transitions delivered via
        # SLOEngine.add_alert_callback(supervisor.on_slo_alert) are
        # recorded + evented (the operator sees WHICH objective burned
        # while a replica was down); the elastic autoscaler acts on them
        self.slo_alerts: List = []

    def on_slo_alert(self, alert) -> None:
        """Callback seam for :meth:`SLOEngine.set_alert_callback`:
        record every alert transition against the fabric's restart
        picture. Host-only, exception-free by construction (appends +
        a telemetry event)."""
        from deepspeed_tpu_torch.telemetry import record_event

        self.slo_alerts.append(alert)
        record_event("fabric/slo_alert", rule=alert.rule, sli=alert.sli,
                     severity=alert.severity, transition=alert.kind,
                     t=alert.t, burn_short=alert.burn_short,
                     burn_long=alert.burn_long)

    def _span(self, name: str, start: float, end: float, **attrs) -> None:
        if self.tracer is None:
            return
        if self._trace is None:
            self._trace = self.tracer.new_trace()
        self.tracer.record(name, start, end, trace_id=self._trace,
                           **attrs)

    def _rec(self, name: str) -> _ReplicaRecord:
        return self._records.setdefault(name, _ReplicaRecord())

    # ------------------------------------------------------------- queries
    def restarts(self, name: str) -> int:
        return self._rec(name).restarts

    def preemption_restarts(self, name: str) -> int:
        return self._rec(name).preemption_restarts

    def is_abandoned(self, name: str) -> bool:
        return self._rec(name).abandoned

    def _budget_spent(self, rec: _ReplicaRecord, now: float) -> int:
        if self.restart_window_s is not None:
            cutoff = now - self.restart_window_s
            rec.restart_times = [t for t in rec.restart_times if t > cutoff]
        return len(rec.restart_times)

    def _backoff_delay(self, consecutive_failures: int) -> float:
        return backoff_delay(consecutive_failures,
                             base_s=self.restart_delay_s,
                             factor=self.backoff_factor,
                             cap_s=self.max_restart_delay_s,
                             jitter=self.jitter, rng=self._rng)

    def rebase(self, shift: float) -> None:
        """Shift every stored instant by ``-shift`` — the router calls
        this when a new run() re-anchors its offset clock, so rolling
        restart windows keep their true age across runs."""
        for rec in self._records.values():
            rec.restart_times = [t - shift for t in rec.restart_times]
            if rec.last_failure_t is not None:
                rec.last_failure_t -= shift

    # ------------------------------------------------------------- decision
    def on_failure(self, name: str, now: float, *,
                   restartable: bool = False) -> Optional[float]:
        """Replica ``name`` failed at ``now``. Returns the instant it
        may be resurrected, or None if it is permanently abandoned.
        ``restartable`` marks infrastructure churn (preemption-style
        exits): restarted without burning budget, with the failure
        backoff reset — exactly the ElasticAgent's restartable-exit
        rule."""
        from deepspeed_tpu_torch.telemetry import record_event

        rec = self._rec(name)
        if rec.abandoned:
            return None
        if restartable:
            rec.consecutive = 0
            rec.consecutive_preemptions += 1
            if rec.consecutive_preemptions > self.max_preemption_restarts:
                logger.error(
                    f"fabric supervisor: replica {name} hit "
                    f"{rec.consecutive_preemptions - 1} consecutive "
                    f"restartable exits — the preemption signal looks "
                    f"persistent; abandoning")
                rec.abandoned = True
                record_event("fabric/replica_abandoned", replica=name,
                             reason="persistent_preemption")
                self._span("replica_abandoned", now, now, replica=name,
                           reason="persistent_preemption")
                return None
            rec.preemption_restarts += 1
            record_event("fabric/replica_preemption_restart", replica=name)
            at = now + self._backoff_delay(rec.consecutive_preemptions)
            self._span("replica_restart_backoff", now, at, replica=name,
                       restartable=True)
            return at
        rec.consecutive_preemptions = 0
        if (self.restart_window_s is not None
                and rec.last_failure_t is not None
                and now - rec.last_failure_t > self.restart_window_s):
            # healthy longer than the whole budget window since the
            # last crash: backoff restarts at base
            rec.consecutive = 0
        rec.last_failure_t = now
        rec.restart_times.append(now)
        spent = self._budget_spent(rec, now)
        if spent > self.max_restarts:
            window = (f"in the last {self.restart_window_s}s"
                      if self.restart_window_s is not None else "total")
            logger.error(
                f"fabric supervisor: abandoning replica {name} after "
                f"{spent - 1} restarts {window} "
                f"(budget {self.max_restarts})")
            rec.abandoned = True
            record_event("fabric/replica_abandoned", replica=name,
                         reason="restart_budget")
            self._span("replica_abandoned", now, now, replica=name,
                       reason="restart_budget")
            return None
        rec.consecutive += 1
        rec.restarts += 1
        delay = self._backoff_delay(rec.consecutive)
        record_event("fabric/replica_restart", replica=name,
                     restart=spent, delay_s=delay)
        self._span("replica_restart_backoff", now, now + delay,
                   replica=name, restart=spent)
        logger.warning(
            f"fabric supervisor: replica {name} crashed; restart "
            f"{spent}/{self.max_restarts} in window, backoff {delay:.2f}s "
            f"(consecutive crash #{rec.consecutive})")
        return now + delay
