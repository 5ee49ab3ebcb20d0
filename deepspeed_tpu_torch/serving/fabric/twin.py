"""Discrete-event digital twin of the elastic serving fabric (port of
deepspeed_tpu/serving/fabric/twin.py).

The fleet-scale chaos harness that makes autoscaler policy SEARCHABLE
offline: one :func:`run_twin` call builds a complete virtual fabric —
FakeClock, private metrics registry, SLO engine, supervisor, elastic
router, optional :class:`ElasticAutoscaler` — over in-process replicas
that all wrap ONE shared :class:`InferenceEngine` (one copy of the
weights and programs for the whole fleet; each replica's warm-up captures
the decode step's CUDA graph over its own KV store on the card),
drives a synthetic multi-tenant arrival trace through a scripted fault
schedule, and returns a :class:`TwinReport` with everything an operator
(or a parameter search) needs to judge the policy:

  * served / shed / failed, per tenant and in total;
  * the full ALERT timeline (every fired/resolved transition,
    injected storms included) and SCALE-DECISION timeline (every
    autoscaler action with its evidence);
  * pool-size series and drain durations;
  * per-SLI attainment and the fabric's recompile count;
  * a :meth:`TwinReport.fingerprint` over all of the above.

Everything runs on the ONE FakeClock (``auto_dt`` advances per read),
every RNG is seeded, and greedy decode is deterministic — so the same
scenario replays BIT-IDENTICALLY: same tokens, same alert instants,
same scale decisions, same fingerprint. The acceptance suite pins
exactly that, plus losslessness against a fault-free fixed-large-pool
oracle.

Fault schedule: a sequence of dicts, each ``{"kind": ..., ...}``:

  ``{"kind": "crash", "replica": "r1", "at_step": 40}``
      replica process dies entering its 40th step (crash storm =
      several of these);
  ``{"kind": "flaky", "replica": "r0", "at_step": 10, "count": 3}``
      retryable step errors (breaker food);
  ``{"kind": "straggle", "replica": "r0", "delay_s": 0.05,
     "from_step": 5, "until_step": 30}``
      virtual-time slow host;
  ``{"kind": "probe_blackout", "replica": "r1", "count": 5}``
      health probes fail while steps keep working;
  ``{"kind": "alert_storm", "start_s": 0.5, "count": 20,
     "period_s": 0.05, "severity": "page"}``
      synthetic flapping alert transitions injected through
      ``SLOEngine.inject_alert`` — the autoscaler-thrash probe.

When ``jsonl_path`` is given the twin streams its full telemetry
(events, slo_eval records, final snapshot) to that file — the input
``scripts/telemetry_report.py``'s ``autoscaler`` section renders.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.serving.errors import EngineConfigError
from deepspeed_tpu_torch.serving.fabric.autoscaler import ElasticAutoscaler
from deepspeed_tpu_torch.serving.fabric.replica import InProcessReplica
from deepspeed_tpu_torch.serving.fabric.router import FabricRouter
from deepspeed_tpu_torch.serving.fabric.supervisor import ReplicaSupervisor
from deepspeed_tpu_torch.serving.scheduler import (Request, bimodal_trace,
                                                   bursty_poisson_trace)
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry
from deepspeed_tpu_torch.telemetry.slo import SLOEngine
from deepspeed_tpu_torch.testing.fault_injection import (FakeClock,
                                                         FaultInjector)

# Twin-native SLO surface: virtual-time windows (the default config's
# 5m/1h SRE ladder would never fire inside a trace that lasts seconds).
# fabric_queue pages when the router backlog sits above the ceiling for
# a sustained fraction of both windows — the overload signature the
# autoscaler scales out on; availability warns on failed finishes.
TWIN_SLO_CONFIG = {
    "slis": [
        {"name": "fabric_queue", "kind": "gauge_ceiling",
         "metric": "fabric/queue_depth", "ceiling": 6.0,
         "objective": 0.9,
         "description": "router backlog stays bounded"},
        {"name": "availability", "kind": "availability",
         "good": "fabric/completed_requests",
         "bad": ["fabric/failed_requests", "fabric/rejected_requests"],
         "objective": 0.999,
         "description": "non-failed finishes across the fabric"},
    ],
    "rules": [
        {"sli": "fabric_queue", "short_s": 0.4, "long_s": 1.6,
         "burn": 3.0, "severity": "page", "min_events": 8},
        {"sli": "availability", "short_s": 2.0, "long_s": 8.0,
         "burn": 2.0, "severity": "warn", "min_events": 10},
    ],
}

_FAULT_KINDS = ("crash", "flaky", "straggle", "probe_blackout",
                "alert_storm")


def _json_default(o):
    """Numpy scalars (trace generators hand them out) -> plain JSON."""
    item = getattr(o, "item", None)
    if callable(item):
        return item()
    return repr(o)


class _TeeSink:
    """In-memory record capture, optionally teed to a JSONL file — the
    twin reads events back for its report AND leaves an on-disk stream
    for telemetry_report."""

    def __init__(self, path=None):
        self.records: List[dict] = []
        self._f = open(path, "w") if path else None

    def write(self, rec: dict) -> None:
        self.records.append(rec)
        if self._f is not None:
            self._f.write(json.dumps(rec, sort_keys=True,
                                     default=_json_default) + "\n")

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def synthetic_tenant_trace(seed: int, vocab_size: int, *,
                           tenants: Sequence[dict]) -> List[Request]:
    """Multi-tenant arrival process from the serving trace generators:
    one sub-trace per tenant spec, tenant-stamped, merged by arrival
    time and re-numbered. Spec fields: ``name`` (tenant id), ``kind``
    (``"bimodal"`` default, or ``"bursty"``), ``n``, plus the
    generator's own knobs (``rate``, ``burst_size``, ...). One seeded
    RNG drives every tenant in spec order — same seed, same trace."""
    import numpy as np

    rng = np.random.RandomState(seed)
    merged: List[Request] = []
    for spec in tenants:
        kind = spec.get("kind", "bimodal")
        n = spec.get("n", 12)
        if kind == "bursty":
            reqs = bursty_poisson_trace(
                rng, n, burst_size=spec.get("burst_size", 6),
                burst_rate=spec.get("rate", 50.0),
                prompt_lens=spec.get("prompt_lens", (4, 6, 8)),
                max_new_choices=spec.get("max_new", (6, 8)),
                vocab_size=vocab_size)
        elif kind == "bimodal":
            reqs = bimodal_trace(
                rng, n, rate=spec.get("rate", 200.0),
                short_lens=spec.get("short_lens", (4, 6, 8)),
                long_lens=spec.get("long_lens", (24,)),
                long_frac=spec.get("long_frac", 0.25),
                short_new=spec.get("short_new", (6, 8)),
                long_new=spec.get("long_new", (6,)),
                vocab_size=vocab_size)
        else:
            raise EngineConfigError(
                f"unknown tenant trace kind {kind!r} "
                f"(want 'bimodal' or 'bursty')")
        for r in reqs:
            r.tenant_id = spec["name"]
        merged.extend(reqs)
    merged.sort(key=lambda r: (r.arrival_time, r.rid))
    for i, r in enumerate(merged):
        r.rid = i
    return merged


@dataclasses.dataclass
class TwinReport:
    """Everything one twin run produced, replay-comparable."""

    served: int
    shed: int
    failed: int
    per_tenant: Dict[str, Dict[str, int]]
    tokens: Dict[int, List[int]]            # rid -> greedy tokens (served)
    alert_timeline: List[Tuple]             # (t, rule, severity, transition)
    scale_timeline: List[Tuple]             # (t, action, reason, replica,
                                            #  pool_before, pool_after)
    pool_sizes: List[Tuple]                 # (t, pool_size) change points
    drain_durations_ms: List[float]
    slo_attainment: Dict[str, float]        # sli -> lifetime good fraction
    recompiles: int
    counters: Dict[str, int]

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["tokens"] = {str(k): v for k, v in sorted(self.tokens.items())}
        return d

    def fingerprint(self) -> str:
        """SHA-256 over the canonical report JSON: two runs of the same
        scenario must match bit-for-bit — tokens, alert instants, scale
        decisions, everything."""
        blob = json.dumps(self.to_json(), sort_keys=True,
                          default=_json_default)
        return hashlib.sha256(blob.encode()).hexdigest()


def run_twin(engine, requests: Sequence[Request], *,
             initial_replicas: int = 2,
             serving_kw: Optional[dict] = None,
             supervisor_kw: Optional[dict] = None,
             router_kw: Optional[dict] = None,
             autoscaler_kw: Optional[dict] = None,
             slo_config: Optional[dict] = None,
             eval_interval_s: float = 0.05,
             faults: Sequence[dict] = (),
             auto_dt: float = 2e-4,
             jsonl_path=None, replica_hook=None) -> TwinReport:
    """One deterministic twin run. ``engine`` is the SHARED
    InferenceEngine every replica wraps; ``requests`` the arrival trace
    (see :func:`synthetic_tenant_trace`). ``autoscaler_kw=None`` runs a
    FIXED pool (the oracle/baseline shape); a dict — even empty —
    arms an :class:`ElasticAutoscaler` with those knobs. ``faults`` is
    the scripted schedule described in the module docstring.
    ``replica_hook``, when given, is called with every replica the twin
    builds (initial, resurrected and scaled-out) before the router sees
    it."""
    from deepspeed_tpu_torch.serving.engine import ServingEngine

    clock = FakeClock(auto_dt=auto_dt)
    inj = FaultInjector()
    sink = _TeeSink(jsonl_path)
    registry = MetricsRegistry()
    registry.attach_sink(sink)
    for f in faults:
        kind = f.get("kind")
        if kind == "crash":
            inj.crash_replica_step(f["replica"], f["at_step"])
        elif kind == "flaky":
            inj.flaky_replica_step(f["replica"], f["at_step"],
                                   f.get("count", 1))
        elif kind == "straggle":
            inj.straggle_replica(f["replica"], f["delay_s"],
                                 from_step=f.get("from_step", 1),
                                 until_step=f.get("until_step"))
        elif kind == "probe_blackout":
            inj.fail_replica_probes(f["replica"], f.get("count", 1))
        elif kind == "alert_storm":
            inj.alert_storm(**{k: v for k, v in f.items()
                               if k != "kind"})
        else:
            raise EngineConfigError(
                f"unknown fault kind {kind!r} (want one of "
                f"{_FAULT_KINDS})")

    skw = dict(num_slots=4, max_len=64, buckets=(16, 64))
    skw.update(serving_kw or {})

    def make_replica(name: str) -> InProcessReplica:
        srv = ServingEngine(engine, time_fn=clock.time,
                            telemetry=registry, **skw)
        replica = InProcessReplica(name, srv, chaos=inj.replica_plan(name),
                                   clock=clock)
        if replica_hook is not None:
            replica_hook(replica)
        return replica

    sup_kw = dict(restart_delay_s=0.05, max_restart_delay_s=0.5,
                  jitter=0.0)
    sup_kw.update(supervisor_kw or {})
    supervisor = ReplicaSupervisor(**sup_kw)
    slo = SLOEngine(TWIN_SLO_CONFIG if slo_config is None else slo_config,
                    registry=registry, time_fn=clock.time,
                    eval_interval_s=eval_interval_s)
    # alert-storm delivery rides the router's once-per-step SLO poll:
    # due synthetic transitions inject BEFORE the real evaluation, on
    # the same clock instant — deterministic ordering, bit-identical
    # replays
    real_maybe_evaluate = slo.maybe_evaluate

    def _maybe_evaluate(now=None):
        t = clock.now if now is None else now
        for alert in inj.due_alerts(t):
            slo.inject_alert(alert)
        return real_maybe_evaluate(now)

    slo.maybe_evaluate = _maybe_evaluate

    # max_dispatch_depth bounds how much work buries itself inside a
    # replica: the backlog stays in the ROUTER queue where the
    # fabric/queue_depth gauge (the twin's page SLI) can see it and the
    # autoscaler can act on it
    rkw = dict(heartbeat_interval_s=0.05, retry_base_delay_s=0.0,
               retry_max_delay_s=0.0, drain_timeout_s=0.5,
               max_dispatch_depth=4)
    rkw.update(router_kw or {})
    router = FabricRouter(
        [make_replica(f"r{i}") for i in range(initial_replicas)],
        replica_factory=make_replica, supervisor=supervisor,
        time_fn=clock.time, telemetry=registry, slo=slo, **rkw)
    autoscaler = None
    if autoscaler_kw is not None:
        autoscaler = ElasticAutoscaler(router, **autoscaler_kw)

    results = router.run(list(requests), warmup=True)
    registry.flush()
    sink.close()

    tenant_of = {r.rid: (r.tenant_id or "default") for r in requests}
    served = shed = failed = 0
    per_tenant: Dict[str, Dict[str, int]] = {}
    tokens: Dict[int, List[int]] = {}
    for res in results:
        tenant = tenant_of.get(res.rid, "default")
        bucket = per_tenant.setdefault(
            tenant, {"served": 0, "shed": 0, "failed": 0, "tokens": 0})
        if res.finish_reason.startswith("shed"):
            shed += 1
            bucket["shed"] += 1
        elif res.finish_reason in ("failed", "rejected"):
            failed += 1
            bucket["failed"] += 1
        else:
            served += 1
            bucket["served"] += 1
            bucket["tokens"] += len(res.tokens)
            tokens[res.rid] = list(res.tokens)

    alert_timeline = [(a.t, a.rule, a.severity, a.kind)
                      for a in slo.alerts]
    scale_timeline = []
    if autoscaler is not None:
        scale_timeline = [(d.t, d.action, d.reason, d.replica,
                           d.pool_before, d.pool_after)
                          for d in autoscaler.decisions]
    pool_sizes: List[Tuple] = [(0.0, initial_replicas)]
    drain_durations: List[float] = []
    for rec in sink.records:
        if rec.get("kind") != "event":
            continue
        name = rec.get("name")
        if name in ("fabric/replica_added", "fabric/replica_removed"):
            pool_sizes.append((rec["t"], rec["pool_size"]))
        if name == "fabric/replica_removed" \
                and rec.get("duration_ms") is not None:
            drain_durations.append(rec["duration_ms"])

    attainment = {}
    for name, st in slo.slis.items():
        if st.samples:
            _, good, total = st.samples[-1]
            if total > 0:
                attainment[name] = round(good / total, 6)

    counters = dict(
        dispatches=router.dispatches, failovers=router.failovers,
        retries=router.retries, timeouts=router.timeouts,
        shed_overload=router.shed_overload,
        shed_deadline=router.shed_deadline,
        replica_crashes=router.replica_crashes,
        replica_restarts=router.replica_restarts,
        quarantines=router.quarantines, completed=router.completed,
        replicas_added=router.replicas_added,
        replicas_removed=router.replicas_removed,
        drain_redispatches=router.drain_redispatches,
        autoscale_suppressed=(autoscaler.suppressed
                              if autoscaler is not None else 0),
        alerts_seen=(autoscaler.alerts_seen
                     if autoscaler is not None else 0))

    return TwinReport(
        served=served, shed=shed, failed=failed, per_tenant=per_tenant,
        tokens=tokens, alert_timeline=alert_timeline,
        scale_timeline=scale_timeline, pool_sizes=pool_sizes,
        drain_durations_ms=drain_durations,
        slo_attainment=attainment,
        recompiles=router.recompile_count(), counters=counters)
