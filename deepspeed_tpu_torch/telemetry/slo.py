"""SLO engine of the port (port of deepspeed_tpu/telemetry/slo.py):
declarative SLIs and multi-window, multi-burn-rate alerting.

* An **SLI** is a good-events / total-events ratio read from the metric
  stream the engines already write: a latency SLI counts histogram
  observations under a threshold ("TTFT <= 500 ms"), an availability SLI
  divides two counters, a gauge SLI counts evaluation samples meeting a
  floor or ceiling ("MFU >= 0.4").
* An **objective** gives the error budget ``1 - objective``; the **burn
  rate** is ``bad_fraction(window) / budget`` (1.0 spends the budget over
  the SLO period exactly).
* An **alert rule** fires only when the burn exceeds its threshold over
  both a short and a long window (the SRE Workbook's multi-window rule:
  the short window detects and resets fast, the long one suppresses
  blips), e.g. 14.4x over 5 min and 1 h -> page; 3x over 1 h and 6 h ->
  warn.

Everything is evaluated on the host on the caller's clock: the serving
engine passes the instants its loop runs on, so a virtual-clock trace
replays its alert timeline exactly. Alerts become typed events in the
telemetry JSONL stream and go to the subscribers of
:meth:`SLOEngine.add_alert_callback` (``set_alert_callback`` replaces
them all), each shielded from the others' exceptions; a page-severity
fire triggers the flight recorder's dump.

Window math: each :meth:`SLOEngine.evaluate` samples every SLI's
cumulative (good, total) counts from the registry into a ring of
``(t, good, total)`` samples kept by age; a window's bad fraction is the
difference against the newest sample at least ``window`` old (the oldest
sample when history is shorter: a young window is shorter, never a
fabricated zero). No locks, no device work.
"""

from __future__ import annotations

import dataclasses
import time
from bisect import bisect_right
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry, get_registry

SEVERITIES = ("page", "warn")
SLI_KINDS = ("latency", "availability", "gauge_floor", "gauge_ceiling")


class SLOConfigError(ValueError):
    """A malformed SLI/rule config, raised with every problem listed, so
    a config author fixes the file in one round trip."""

    def __init__(self, errors: Sequence[str]):
        self.errors = list(errors)
        super().__init__("invalid SLO config:\n  " + "\n  ".join(self.errors))


@dataclasses.dataclass(frozen=True)
class SLI:
    """One service-level indicator over the existing metric stream.

    kind "latency": ``metric`` names a latency HISTOGRAM; an
        observation is good when it is <= ``threshold_ms`` (bucket
        upper bounds are the resolution — pick a threshold on or near
        a bucket edge for exact counting).
    kind "availability": ``good``/``bad`` name COUNTERS (``bad`` may be
        a list, summed);
        total = good + bad.
    kind "gauge_floor"/"gauge_ceiling": ``metric`` names a GAUGE; each
        SLO evaluation contributes ONE sample, good when the gauge is
        >= ``floor`` (resp. <= ``ceiling``). An unset gauge contributes
        nothing.

    ``objective`` is the target good fraction in (0, 1);
    ``1 - objective`` is the error budget every burn rate divides by.
    """

    name: str
    kind: str
    objective: float
    metric: Optional[str] = None
    threshold_ms: Optional[float] = None
    good: Optional[str] = None
    bad: Optional[Tuple[str, ...]] = None
    floor: Optional[float] = None
    ceiling: Optional[float] = None
    description: str = ""


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """Fire when ``sli``'s burn rate exceeds ``burn`` over BOTH windows.
    ``min_events`` gates on the long window's total event count so a
    near-empty service cannot page off its first bad request."""

    sli: str
    short_s: float
    long_s: float
    burn: float
    severity: str = "page"
    min_events: int = 10

    @property
    def name(self) -> str:
        return f"{self.sli}:{self.severity}:{self.burn:g}x"


@dataclasses.dataclass(frozen=True)
class SLOAlert:
    """One alert-state transition, delivered to the callback seam and
    (as an event) to the JSONL stream."""

    rule: str
    sli: str
    severity: str
    kind: str            # "fired" | "resolved"
    t: float
    burn_short: float
    burn_long: float
    budget_consumed: float


# --------------------------------------------------------------- defaults
# The reference's default SLO surface, kept as it is (its availability
# SLI reads a serving fabric's counters). The thresholds are loose: a
# healthy trace runs alert-free, an overload burst blows past them.
DEFAULT_SLO_CONFIG = {
    "slis": [
        {"name": "ttft_interactive", "kind": "latency",
         "metric": "serving/ttft_ms/p0", "threshold_ms": 1000.0,
         "objective": 0.99,
         "description": "interactive-class time-to-first-token"},
        {"name": "tpot", "kind": "latency", "metric": "serving/tpot_ms",
         "threshold_ms": 200.0, "objective": 0.99,
         "description": "per-output-token latency, all classes"},
        {"name": "queue_wait", "kind": "latency",
         "metric": "serving/queue_wait_ms", "threshold_ms": 2000.0,
         "objective": 0.95,
         "description": "admission queue wait incl. preempted time"},
        {"name": "availability", "kind": "availability",
         "good": "fabric/completed_requests",
         "bad": ["fabric/failed_requests", "fabric/rejected_requests"],
         "objective": 0.999,
         "description": "non-failed finishes across the fabric"},
        {"name": "train_mfu", "kind": "gauge_floor", "metric": "train/mfu",
         "floor": 0.30, "objective": 0.90,
         "description": "model-flops-utilization floor"},
        {"name": "train_anomaly_rate", "kind": "availability",
         "good": "train/steps",
         "bad": ["resilience/anomalies_nonfinite",
                 "resilience/anomalies_spike",
                 "resilience/anomalies_divergence",
                 "resilience/anomalies_sdc",
                 "resilience/anomalies_replay"],
         "objective": 0.99,
         "description": "training steps without an actionable anomaly"},
    ],
    "rules": [
        # the SRE Workbook ladder: fast-burn page, slow-burn warn
        {"sli": "ttft_interactive", "short_s": 300.0, "long_s": 3600.0,
         "burn": 14.4, "severity": "page"},
        {"sli": "ttft_interactive", "short_s": 3600.0, "long_s": 21600.0,
         "burn": 3.0, "severity": "warn"},
        {"sli": "tpot", "short_s": 300.0, "long_s": 3600.0,
         "burn": 14.4, "severity": "page"},
        {"sli": "queue_wait", "short_s": 3600.0, "long_s": 21600.0,
         "burn": 3.0, "severity": "warn"},
        {"sli": "availability", "short_s": 300.0, "long_s": 3600.0,
         "burn": 14.4, "severity": "page"},
        {"sli": "train_mfu", "short_s": 3600.0, "long_s": 21600.0,
         "burn": 3.0, "severity": "warn"},
        {"sli": "train_anomaly_rate", "short_s": 300.0, "long_s": 3600.0,
         "burn": 14.4, "severity": "page"},
    ],
}


# ------------------------------------------------------------- validation
def validate_slo_config(cfg: dict) -> List[str]:
    """Every problem in ``cfg``, as human-readable strings (empty list =
    valid):

      * unknown/duplicate SLI names, unknown kinds/severities;
      * missing per-kind fields (latency without a metric/threshold,
        availability without good/bad counters, gauge without a bound);
      * objectives outside (0, 1);
      * malformed windows (non-positive, or short >= long);
      * burn thresholds that can NEVER fire: the windowed bad fraction
        is at most 1.0, so any ``burn > 1 / (1 - objective)`` is
        structurally unreachable — a rule that looks armed but is dead.
    """
    errors: List[str] = []
    if not isinstance(cfg, dict):
        return [f"config must be a dict, got {type(cfg).__name__}"]
    slis = cfg.get("slis", [])
    rules = cfg.get("rules", [])
    if not isinstance(slis, list) or not isinstance(rules, list):
        return ["'slis' and 'rules' must be lists"]
    by_name: Dict[str, dict] = {}
    for i, s in enumerate(slis):
        where = f"slis[{i}]"
        if not isinstance(s, dict):
            errors.append(f"{where}: must be a dict")
            continue
        name = s.get("name")
        if not name or not isinstance(name, str):
            errors.append(f"{where}: missing 'name'")
            continue
        if name in by_name:
            errors.append(f"{where}: duplicate SLI name {name!r}")
        by_name[name] = s
        obj = s.get("objective")
        if not isinstance(obj, (int, float)) or not 0.0 < obj < 1.0:
            errors.append(f"{where} ({name}): objective must be in (0, 1), "
                          f"got {obj!r}")
        kind = s.get("kind")
        if kind not in SLI_KINDS:
            errors.append(f"{where} ({name}): unknown kind {kind!r} "
                          f"(one of {SLI_KINDS})")
            continue
        if kind == "latency":
            if not s.get("metric"):
                errors.append(f"{where} ({name}): latency SLI needs "
                              f"'metric' (a histogram name)")
            th = s.get("threshold_ms")
            if not isinstance(th, (int, float)) or th <= 0:
                errors.append(f"{where} ({name}): latency SLI needs a "
                              f"positive 'threshold_ms', got {th!r}")
        elif kind == "availability":
            if not s.get("good"):
                errors.append(f"{where} ({name}): availability SLI needs "
                              f"'good' (a counter name)")
            bad = s.get("bad")
            if not bad or not (isinstance(bad, str)
                               or (isinstance(bad, (list, tuple))
                                   and all(isinstance(b, str)
                                           for b in bad))):
                errors.append(f"{where} ({name}): availability SLI needs "
                              f"'bad' (a counter name or list of them)")
        else:  # gauge_floor / gauge_ceiling
            if not s.get("metric"):
                errors.append(f"{where} ({name}): gauge SLI needs "
                              f"'metric' (a gauge name)")
            bound = "floor" if kind == "gauge_floor" else "ceiling"
            if not isinstance(s.get(bound), (int, float)):
                errors.append(f"{where} ({name}): {kind} SLI needs a "
                              f"numeric '{bound}'")
    for i, r in enumerate(rules):
        where = f"rules[{i}]"
        if not isinstance(r, dict):
            errors.append(f"{where}: must be a dict")
            continue
        sli = r.get("sli")
        if sli not in by_name:
            errors.append(f"{where}: unknown SLI name {sli!r} "
                          f"(defined: {sorted(by_name) or 'none'})")
        sev = r.get("severity", "page")
        if sev not in SEVERITIES:
            errors.append(f"{where} ({sli}): unknown severity {sev!r} "
                          f"(one of {SEVERITIES})")
        short_s, long_s = r.get("short_s"), r.get("long_s")
        for fld, v in (("short_s", short_s), ("long_s", long_s)):
            if not isinstance(v, (int, float)) or v <= 0:
                errors.append(f"{where} ({sli}): {fld} must be a positive "
                              f"number, got {v!r}")
        if (isinstance(short_s, (int, float))
                and isinstance(long_s, (int, float))
                and 0 < long_s <= short_s):
            errors.append(f"{where} ({sli}): short window {short_s}s must "
                          f"be strictly inside the long window {long_s}s")
        burn = r.get("burn")
        if not isinstance(burn, (int, float)) or burn <= 0:
            errors.append(f"{where} ({sli}): burn must be a positive "
                          f"number, got {burn!r}")
        elif sli in by_name:
            obj = by_name[sli].get("objective")
            if isinstance(obj, (int, float)) and 0.0 < obj < 1.0:
                max_burn = 1.0 / (1.0 - obj)
                if burn > max_burn:
                    errors.append(
                        f"{where} ({sli}): burn {burn}x can never fire — "
                        f"bad fraction caps at 1.0, so the max reachable "
                        f"burn at objective {obj} is {max_burn:.4g}x")
        me = r.get("min_events", 10)
        if not isinstance(me, int) or me < 0:
            errors.append(f"{where} ({sli}): min_events must be a "
                          f"non-negative int, got {me!r}")
    return errors


def parse_slo_config(cfg: dict) -> Tuple[List[SLI], List[BurnRateRule]]:
    """Validate + materialize a config dict; raises
    :class:`SLOConfigError` listing EVERY problem on failure."""
    errors = validate_slo_config(cfg)
    if errors:
        raise SLOConfigError(errors)
    slis = []
    for s in cfg.get("slis", []):
        bad = s.get("bad")
        if isinstance(bad, str):
            bad = (bad,)
        elif bad is not None:
            bad = tuple(bad)
        slis.append(SLI(name=s["name"], kind=s["kind"],
                        objective=float(s["objective"]),
                        metric=s.get("metric"),
                        threshold_ms=s.get("threshold_ms"),
                        good=s.get("good"), bad=bad,
                        floor=s.get("floor"), ceiling=s.get("ceiling"),
                        description=s.get("description", "")))
    rules = [BurnRateRule(sli=r["sli"], short_s=float(r["short_s"]),
                          long_s=float(r["long_s"]), burn=float(r["burn"]),
                          severity=r.get("severity", "page"),
                          min_events=int(r.get("min_events", 10)))
             for r in cfg.get("rules", [])]
    return slis, rules


# ----------------------------------------------------------------- engine
class _SliState:
    """Per-SLI sample ring + lifetime accumulators. The ring is
    retained by AGE (every sample younger than the rules' longest
    window, plus the one older anchor the window diff needs), not by a
    fixed count — a count bound silently shortened the 6h windows to
    however long the ring happened to cover. ``cap`` is a hard safety
    bound against a pathological evaluation storm; past it the oldest
    samples go and the longest windows degrade toward the ring's span
    (documented, never silent truncation of the math itself)."""

    __slots__ = ("sli", "samples", "cap", "gauge_good", "gauge_total")

    def __init__(self, sli: SLI, cap: int):
        self.sli = sli
        # (t, cumulative_good, cumulative_total)
        self.samples: deque = deque()
        self.cap = max(int(cap), 4)
        # gauge SLIs synthesize their own cumulative counts (one
        # observation per evaluation)
        self.gauge_good = 0
        self.gauge_total = 0

    def prune(self, now: float, max_window: float) -> None:
        """Drop samples no window can anchor on: everything older than
        ``max_window`` EXCEPT the newest such sample (the long window's
        anchor must be the newest sample at least window old)."""
        cutoff = now - max_window
        samples = self.samples
        while len(samples) >= 2 and samples[1][0] <= cutoff:
            samples.popleft()
        while len(samples) > self.cap:
            samples.popleft()


class SLOEngine:
    """Evaluates SLIs + burn-rate rules against a metrics registry.

    Parameters
    ----------
    config: the declarative dict (see :data:`DEFAULT_SLO_CONFIG`);
        validated up front with typed errors.
    registry: the MetricsRegistry to read SLI inputs from (and emit
        alert events into). Defaults to the process-global registry.
    time_fn: fallback clock for :meth:`evaluate` / ``maybe_evaluate``
        called without an explicit ``now`` — the engines always pass
        their own (possibly virtual) clock instants, so chaos runs
        replay alert timelines deterministically.
    eval_interval_s: ``maybe_evaluate`` cadence gate (evaluations are
        cheap — a handful of dict reads — but sub-interval calls are
        pointless).
    max_samples_per_sli: HARD memory cap on each SLI's sample ring.
        Samples are normally retained by age — everything inside the
        rules' longest window (so the default 6h windows stay honest
        at any evaluation cadence); the cap only binds under an
        evaluation storm, where the oldest samples go and the longest
        windows degrade toward the ring's span.
    flight_recorder: optional
        :class:`~deepspeed_tpu_torch.telemetry.flight_recorder.FlightRecorder`;
        every evaluation record lands in its alert ring, and a
        page-severity FIRE triggers a dump.
    """

    def __init__(self, config: Optional[dict] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 time_fn: Optional[Callable[[], float]] = None,
                 eval_interval_s: float = 1.0,
                 max_samples_per_sli: int = 100_000,
                 flight_recorder=None):
        slis, rules = parse_slo_config(
            DEFAULT_SLO_CONFIG if config is None else config)
        self.registry = registry if registry is not None else get_registry()
        self._time = time_fn or time.monotonic
        self.eval_interval_s = float(eval_interval_s)
        self.flight_recorder = flight_recorder
        self.slis: Dict[str, _SliState] = {
            s.name: _SliState(s, max_samples_per_sli) for s in slis}
        self.rules: List[BurnRateRule] = rules
        # age-based ring retention horizon: the longest rule window
        # (+5% slack so an anchor never ages out mid-evaluation)
        self._max_window = max((r.long_s for r in rules),
                               default=0.0) * 1.05
        self._firing: Dict[str, bool] = {r.name: False for r in rules}
        self._callbacks: List[Callable[[SLOAlert], None]] = []
        self._last_eval: Optional[float] = None
        self.evaluations = 0
        self.alerts: List[SLOAlert] = []     # full fired/resolved history

    # -------------------------------------------------------------- seams
    def add_alert_callback(self,
                           cb: Callable[[SLOAlert], None]) -> None:
        """Subscribe ``cb`` to every alert transition (the fan-out lives
        here, not in the callers). Delivery order is subscription order;
        duplicate subscriptions are idempotent. Each subscriber's
        exceptions are swallowed INDIVIDUALLY: one broken pager must
        neither take down the serving loop nor starve the subscribers
        behind it."""
        if cb not in self._callbacks:
            self._callbacks.append(cb)

    def remove_alert_callback(self,
                              cb: Callable[[SLOAlert], None]) -> None:
        """Unsubscribe; unknown callbacks are ignored."""
        if cb in self._callbacks:
            self._callbacks.remove(cb)

    def set_alert_callback(self,
                           cb: Optional[Callable[[SLOAlert], None]]) -> None:
        """Single-subscriber shim: REPLACES the whole
        subscriber list (``None`` clears it), preserving the original
        set-and-overwrite semantics for existing call sites. New code
        uses :meth:`add_alert_callback`."""
        self._callbacks = [] if cb is None else [cb]

    def inject_alert(self, alert: SLOAlert) -> None:
        """Chaos seam: deliver a SYNTHETIC alert transition
        through the same emit path real evaluations use — events,
        subscriber fan-out, flight-recorder trigger — without touching
        the burn-rate state machine (``firing()`` is unaffected, and a
        later real evaluation is not confused by the injection)."""
        self.alerts.append(alert)
        self._emit(alert)

    # ----------------------------------------------------------- sampling
    def _cumulative(self, st: _SliState) -> Tuple[float, float]:
        """This instant's lifetime (good, total) event counts for one
        SLI, read from the registry (gauge SLIs: the synthesized
        per-evaluation sample counters)."""
        s = st.sli
        if s.kind == "latency":
            h = self.registry._histograms.get(s.metric)
            if h is None or h.count == 0:
                return 0.0, 0.0
            n_good_buckets = bisect_right(h.buckets, s.threshold_ms)
            good = float(sum(h.counts[:n_good_buckets]))
            return good, float(h.count)
        if s.kind == "availability":
            cs = self.registry._counters
            good = float(cs[s.good].value) if s.good in cs else 0.0
            bad = float(sum(cs[b].value for b in s.bad if b in cs))
            return good, good + bad
        # gauge_floor / gauge_ceiling: one observation per evaluation
        g = self.registry._gauges.get(s.metric)
        if g is not None and g.value is not None:
            v = float(g.value)
            ok = (v >= s.floor) if s.kind == "gauge_floor" \
                else (v <= s.ceiling)
            st.gauge_total += 1
            if ok:
                st.gauge_good += 1
        return float(st.gauge_good), float(st.gauge_total)

    def _window(self, st: _SliState, now: float,
                window_s: float) -> Tuple[Optional[float], float]:
        """(bad_fraction, total_events) over the trailing window: the
        newest sample at least ``window_s`` old anchors the diff (the
        oldest sample when history is shorter). None = no events in
        the window — distinct from a clean 0.0."""
        if not st.samples:
            return None, 0.0
        samples = st.samples
        newest = samples[-1]
        anchor = samples[0]
        cutoff = now - window_s
        if anchor[0] <= cutoff:
            # the window starts inside the ring: find the newest sample
            # at least window_s old, scanning from whichever end the
            # cutoff is nearer (the ring is retained to the LONGEST
            # rule window, so that window's anchor lives near the old
            # end — a right-to-left scan there would walk everything)
            if cutoff - anchor[0] <= newest[0] - cutoff:
                for s in samples:
                    if s[0] > cutoff:
                        break
                    anchor = s
            else:
                for s in reversed(samples):
                    if s[0] <= cutoff:
                        anchor = s
                        break
        good = newest[1] - anchor[1]
        total = newest[2] - anchor[2]
        if total <= 0:
            return None, 0.0
        return max(1.0 - good / total, 0.0), total

    def budget_consumed(self, sli_name: str) -> Optional[float]:
        """Lifetime error-budget consumption for one SLI: bad fraction
        since the engine started, divided by the budget. 1.0 = the
        whole budget is gone; None = no events yet."""
        st = self.slis.get(sli_name)
        if st is None or not st.samples:
            return None
        _, good, total = st.samples[-1]
        if total <= 0:
            return None
        bad_frac = max(1.0 - good / total, 0.0)
        return bad_frac / (1.0 - st.sli.objective)

    # --------------------------------------------------------- evaluation
    def maybe_evaluate(self, now: Optional[float] = None) -> List[SLOAlert]:
        """Interval-gated :meth:`evaluate` — the engines call this once
        per serving iteration."""
        if now is None:
            now = self._time()
        if (self._last_eval is not None
                and now - self._last_eval < self.eval_interval_s):
            return []
        return self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> List[SLOAlert]:
        """Sample every SLI, evaluate every rule, emit alert
        transitions. Returns the transitions that happened THIS
        evaluation (also appended to :attr:`alerts`)."""
        if now is None:
            now = self._time()
        self._last_eval = now
        self.evaluations += 1
        for st in self.slis.values():
            good, total = self._cumulative(st)
            if not st.samples:
                # implicit zero baseline: before the engine existed
                # there were no events, so the first evaluation's
                # window covers everything observed so far
                st.samples.append((now, 0.0, 0.0))
            st.samples.append((now, good, total))
            st.prune(now, self._max_window)
        transitions: List[SLOAlert] = []
        rule_stats: Dict[str, dict] = {}
        for rule in self.rules:
            st = self.slis[rule.sli]
            budget = 1.0 - st.sli.objective
            bad_s, _ = self._window(st, now, rule.short_s)
            bad_l, total_l = self._window(st, now, rule.long_s)
            burn_s = (bad_s / budget) if bad_s is not None else 0.0
            burn_l = (bad_l / budget) if bad_l is not None else 0.0
            breached = (bad_s is not None and bad_l is not None
                        and burn_s >= rule.burn and burn_l >= rule.burn
                        and total_l >= rule.min_events)
            rule_stats[rule.name] = {
                "burn_short": round(burn_s, 4),
                "burn_long": round(burn_l, 4),
                "firing": breached}
            was = self._firing[rule.name]
            if breached == was:
                continue
            self._firing[rule.name] = breached
            alert = SLOAlert(
                rule=rule.name, sli=rule.sli, severity=rule.severity,
                kind="fired" if breached else "resolved", t=now,
                burn_short=round(burn_s, 4), burn_long=round(burn_l, 4),
                budget_consumed=round(
                    self.budget_consumed(rule.sli) or 0.0, 4))
            transitions.append(alert)
            self.alerts.append(alert)
            self._emit(alert)
        self._stream_eval(now, rule_stats)
        return transitions

    def _emit(self, alert: SLOAlert) -> None:
        fields = dataclasses.asdict(alert)
        # the record's "kind" is the JSONL discriminator ("event") —
        # the alert's own kind rides as "transition"
        fields["transition"] = fields.pop("kind")
        if alert.kind == "fired":
            self.registry.event("slo/alert_fired", **fields)
        else:
            self.registry.event("slo/alert_resolved", **fields)
        for cb in list(self._callbacks):
            try:
                cb(alert)
            except Exception:  # a broken subscriber must not stop serving
                pass           # — nor starve the subscribers after it
        if self.flight_recorder is not None and alert.kind == "fired" \
                and alert.severity == "page":
            self.flight_recorder.trigger(
                "slo_page", rule=alert.rule, sli=alert.sli, t=alert.t,
                burn_short=alert.burn_short, burn_long=alert.burn_long)

    def _stream_eval(self, now: float, rule_stats: Dict[str, dict]) -> None:
        """One ``{"kind": "slo_eval"}`` record per evaluation: the
        burn-rate timeline the report's slo section renders, and the
        flight recorder's last-N-evaluations ring entry."""
        rec = {
            "kind": "slo_eval", "t": now,
            "rules": rule_stats,
            "budget_consumed": {
                name: round(c, 4)
                for name in self.slis
                if (c := self.budget_consumed(name)) is not None},
        }
        if self.flight_recorder is not None:
            self.flight_recorder.note_alert(rec)
        sink = self.registry.sink
        if sink is not None:
            try:
                sink.write(rec)
            except Exception:
                pass

    # ------------------------------------------------------------ queries
    def firing(self) -> List[str]:
        """Rule names currently in the firing state."""
        return [name for name, on in self._firing.items() if on]

    def __repr__(self):
        return (f"SLOEngine(slis={sorted(self.slis)}, "
                f"rules={len(self.rules)}, evaluations={self.evaluations}, "
                f"firing={self.firing()})")
