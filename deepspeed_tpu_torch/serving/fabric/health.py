"""Per-replica circuit breaker for the serving fabric (port of
deepspeed_tpu/serving/fabric/health.py).

The classic three-state breaker, specialised for the router's failure
model:

  * **closed** — healthy: dispatch and heartbeats flow normally.
    ``failure_threshold`` CONSECUTIVE failures (failed probes, flaky
    steps) trip it open — one transient never quarantines a replica,
    a run of them does.
  * **open** — quarantined: no dispatch, no routine heartbeats. After
    ``cooldown_s`` the next :meth:`allow` transitions to half-open.
  * **half_open** — exactly ONE trial operation (a health probe) is
    allowed through. Success closes the breaker (full recovery);
    failure re-opens it and restarts the cooldown, so a still-sick
    replica is probed once per cooldown, not hammered.

All transitions are driven by the caller's clock (virtual in tests),
never wall time, and the state history is counted for telemetry.
"""

from __future__ import annotations

from typing import Optional

from deepspeed_tpu_torch.serving.errors import EngineConfigError

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# numeric encoding for the per-replica state gauge (telemetry): higher
# is worse, "dead"/"restarting" extend the scale in the router
STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:
    def __init__(self, *, failure_threshold: int = 3,
                 cooldown_s: float = 1.0):
        if failure_threshold < 1:
            raise EngineConfigError(f"failure_threshold must be >= 1, "
                             f"got {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.trips = 0       # closed/half_open -> open transitions
        self.recoveries = 0  # half_open -> closed transitions

    def record_success(self, now: float) -> None:
        """A probe or step succeeded: a half-open trial recovers the
        breaker; in any state the consecutive-failure run resets."""
        self.consecutive_failures = 0
        if self.state == HALF_OPEN:
            self.recoveries += 1
        if self.state != CLOSED:
            self.state = CLOSED
            self.opened_at = None

    def record_failure(self, now: float) -> bool:
        """A probe or step failed. Returns True when THIS failure
        tripped the breaker open (the caller quarantines the replica
        exactly once per trip)."""
        if self.state == HALF_OPEN:
            # the single trial failed: straight back to quarantine, new
            # cooldown window
            self.state = OPEN
            self.opened_at = now
            self.trips += 1
            return True
        self.consecutive_failures += 1
        if (self.state == CLOSED
                and self.consecutive_failures >= self.failure_threshold):
            self.state = OPEN
            self.opened_at = now
            self.trips += 1
            return True
        if self.state == OPEN:
            self.opened_at = now  # failure during quarantine: restart cooldown
        return False

    def trip(self, now: float) -> None:
        """Force the breaker OPEN (the router's straggler path: a
        replica whose steps SUCCEED but whose requests keep eating
        per-attempt timeouts never records an error, so timeout strikes
        trip it explicitly)."""
        if self.state != OPEN:
            self.trips += 1
        self.state = OPEN
        self.opened_at = now
        self.consecutive_failures = 0

    def allow_probe(self, now: float) -> bool:
        """May a trial operation run now? Closed: always. Open: only
        once the cooldown elapsed — which moves the breaker to
        half-open and admits exactly one trial. Half-open: the one
        trial is already outstanding, no more until it resolves."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN and self.opened_at is not None \
                and now - self.opened_at >= self.cooldown_s:
            self.state = HALF_OPEN
            return True
        return False

    @property
    def dispatchable(self) -> bool:
        """New work goes only to CLOSED replicas — a half-open trial is
        a probe, not a place to park a user request."""
        return self.state == CLOSED

    def __repr__(self):
        return (f"CircuitBreaker(state={self.state}, "
                f"fails={self.consecutive_failures}/"
                f"{self.failure_threshold}, trips={self.trips})")
