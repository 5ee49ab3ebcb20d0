"""Elastic agent — restart-on-failure worker supervision (port of
deepspeed_tpu/elasticity/elastic_agent.py).

Reference analog: ``DSElasticAgent(LocalElasticAgent)``
(elasticity/elastic_agent.py:28, torchelastic integration): when any worker
dies, tear the group down and restart it, letting the job resume from its
latest checkpoint.  Paired with the batch-ladder (`compute_elastic_config`)
and sharding-agnostic checkpoints, a restart on a different world size keeps
the global batch valid.

Fault-tolerance semantics:

* **Rolling restart budget** — only restarts inside the trailing
  ``restart_window_s`` count against ``max_restarts``. A job that crashes
  three times in week one shouldn't be one crash from death in week four;
  old restarts age out of the window.
* **Exponential backoff + jitter** — consecutive failures back off
  ``restart_delay_s * backoff_factor**k`` (capped), jittered so a pod's
  agents don't re-rendezvous in lockstep against a struggling coordinator.
* **Restartable exit codes** — :data:`PREEMPTION_EXIT_CODE` (a worker's
  preemption handler finished its final checkpoint) restarts without
  burning budget and resets the failure backoff: preemption is
  infrastructure churn, not job failure. Back-to-back restartable exits
  get their own escalating delay and a generous cap
  (``max_preemption_restarts``) so a persistent maintenance signal can't
  hot-loop the agent forever.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterable, List, Optional

from deepspeed_tpu_torch.elasticity.preemption import PREEMPTION_EXIT_CODE
from deepspeed_tpu_torch.utils.logging import logger


class RollingWindowBudget:
    """Rolling-window event budget — :class:`ElasticAgent`'s restart-budget
    semantics factored out for reuse (the training engine's
    anomaly-rewind budget). Only events inside the trailing ``window_s``
    count against ``max_events``; a job that rewound three times in week
    one shouldn't be one anomaly from death in week four. ``window_s=None``
    counts every event forever. ``time_fn`` is injectable for virtual-time
    tests."""

    def __init__(self, max_events: int, window_s: Optional[float] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self.max_events = max_events
        self.window_s = window_s
        self.time_fn = time_fn
        self._times: List[float] = []

    def spent(self, now: Optional[float] = None) -> int:
        """Events still inside the rolling window (all of them when no
        window is configured); prunes aged-out entries."""
        now = self.time_fn() if now is None else now
        if self.window_s is not None:
            cutoff = now - self.window_s
            self._times = [t for t in self._times if t > cutoff]
        return len(self._times)

    def record(self, now: Optional[float] = None) -> int:
        """Record one event; returns the in-window count including it."""
        now = self.time_fn() if now is None else now
        self._times.append(now)
        return self.spent(now)

    def exceeded(self, now: Optional[float] = None) -> bool:
        return self.spent(now) > self.max_events


def backoff_delay(consecutive_failures: int, *, base_s: float,
                  factor: float, cap_s: float, jitter: float = 0.0,
                  rng=random) -> float:
    """Capped exponential backoff with optional jitter — the restart
    schedule shared by :class:`ElasticAgent` (training worker groups)
    and the JAX package's serving-fabric replica supervisor:
    ``base_s * factor**(k-1)``, capped at ``cap_s``, jittered
    multiplicatively so a fleet's agents don't re-rendezvous in
    lockstep. ``rng`` is injectable for deterministic tests."""
    delay = min(cap_s, base_s * factor ** max(consecutive_failures - 1, 0))
    if jitter:
        delay *= 1.0 + jitter * rng.uniform(-1.0, 1.0)
    return max(delay, 0.0)


class ElasticAgent:
    def __init__(self, spawn_fn: Callable[[], List], monitor_fn: Callable,
                 max_restarts: int = 3, restart_delay_s: float = 1.0,
                 max_restart_delay_s: float = 60.0, backoff_factor: float = 2.0,
                 jitter: float = 0.3,
                 restart_window_s: Optional[float] = None,
                 restartable_exit_codes: Iterable[int] = (PREEMPTION_EXIT_CODE,),
                 max_preemption_restarts: int = 100,
                 time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.spawn_fn = spawn_fn
        self.monitor_fn = monitor_fn
        self.max_restarts = max_restarts
        self.restart_delay_s = restart_delay_s
        self.max_restart_delay_s = max_restart_delay_s
        self.backoff_factor = backoff_factor
        self.jitter = jitter
        self.restart_window_s = restart_window_s
        self.restartable_exit_codes = frozenset(restartable_exit_codes)
        self.max_preemption_restarts = max_preemption_restarts
        self.time_fn = time_fn
        self.sleep_fn = sleep_fn
        self.restart_count = 0        # budget-burning restarts, ever
        self.preemption_restarts = 0  # free restarts (restartable exit codes)
        self._budget = RollingWindowBudget(max_restarts, restart_window_s,
                                           time_fn=time_fn)
        self._last_failure_t: Optional[float] = None

    def _budget_spent(self, now: float) -> int:
        """Restarts still inside the rolling window (all of them when no
        window is configured)."""
        return self._budget.spent(now)

    def _backoff_delay(self, consecutive_failures: int) -> float:
        return backoff_delay(consecutive_failures,
                             base_s=self.restart_delay_s,
                             factor=self.backoff_factor,
                             cap_s=self.max_restart_delay_s,
                             jitter=self.jitter)

    def run(self) -> int:
        """Supervise worker groups until clean exit or restart budget spent.
        Returns the final exit code."""
        consecutive = 0
        consecutive_preemptions = 0
        while True:
            procs = self.spawn_fn()
            rc = self.monitor_fn(procs)
            if rc == 0:
                return 0
            if rc in self.restartable_exit_codes:
                from deepspeed_tpu_torch.telemetry import record_event

                record_event("elastic/preemption_restarts", exit_code=rc)
                self.preemption_restarts += 1
                consecutive_preemptions += 1
                consecutive = 0  # infra churn, not a failing job
                if consecutive_preemptions > self.max_preemption_restarts:
                    # a group that *deterministically* exits restartable
                    # (e.g. a stuck maintenance event re-observed by every
                    # respawn) must not hot-loop forever
                    logger.error(
                        f"elastic agent: {consecutive_preemptions - 1} "
                        f"consecutive restartable exits (code {rc}) — the "
                        f"preemption signal looks persistent; giving up")
                    return rc
                logger.warning(
                    f"elastic agent: worker group exited restartable "
                    f"(code {rc}, preemption); restarting without burning "
                    f"budget (free restart #{self.preemption_restarts})")
                # escalate delay across back-to-back preemptions so a
                # still-pending maintenance event isn't polled in a tight loop
                self.sleep_fn(self._backoff_delay(consecutive_preemptions))
                continue
            consecutive_preemptions = 0
            now = self.time_fn()
            if (self.restart_window_s is not None
                    and self._last_failure_t is not None
                    and now - self._last_failure_t > self.restart_window_s):
                # the group outlived the budget window since the last crash:
                # it's healthy between failures, so backoff restarts at base
                consecutive = 0
            self._last_failure_t = now
            self.restart_count += 1
            from deepspeed_tpu_torch.telemetry import record_event

            record_event("elastic/restarts", exit_code=rc)
            spent = self._budget.record(now)
            if spent > self.max_restarts:
                window = (f"in the last {self.restart_window_s}s"
                          if self.restart_window_s is not None else "total")
                logger.error(
                    f"elastic agent: giving up after {spent - 1} restarts "
                    f"{window} (budget {self.max_restarts}, last exit code {rc})")
                return rc
            consecutive += 1
            delay = self._backoff_delay(consecutive)
            logger.warning(
                f"elastic agent: worker group failed (exit {rc}); restart "
                f"{spent}/{self.max_restarts} in window, backoff "
                f"{delay:.2f}s (consecutive failure #{consecutive})")
            self.sleep_fn(delay)
