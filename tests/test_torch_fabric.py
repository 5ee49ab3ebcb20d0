"""The port's serving fabric (serving/fabric/: router, circuit breaker,
replica supervisor, in-process replicas; the replica seams of
testing/fault_injection.py) held against the JAX package's on the CPU.

Both packages serve the tiny GPT-2 in fp32 with the same weights (the JAX
engine's, carried over by the weight bridge): one module fixture per
package holds one ``InferenceEngine`` that every replica's
``ServingEngine`` wraps. Each scenario of the JAX package's
``tests/unit/serving/test_fabric.py`` runs on both sides with the same
seeded trace, the same fault schedule and a ``FakeClock`` each, and what
it produces is held equal, exactly, by field:

* ``CircuitBreaker`` transitions (each call's return, then state,
  failure run, cooldown anchor, trips, recoveries) on scripted sequences;
  ``ReplicaSupervisor`` decisions (respawn instants, abandonment, restart
  counts) on scripted crash schedules, seeded jitter and ``rebase``;
* per result: tokens, token instants, finish reason and instant,
  ``failovers``, ``replica``; the router's counters; every breaker's state,
  trips and recoveries; the ``fabric/*`` counters and histogram counts of
  the registry;
* the scenario's own pins as the reference states them: losslessness
  against a fault-free single-replica run, zero recompiles, the client's
  stream equal to the result tokens, quarantine and recovery, shedding.

Port-only pins: a device error inside a replica's step propagates out of
the router (it is never failed over as a crash); a crashed or retired
replica drops its ``ServingEngine`` (the card memory of a dead replica);
every replica owns its decode graph program over the inference engine's
one graph pool (a departure of mechanism: the reference's replicas share
one jit cache); in bf16 a failed-over request's tail equals a fault-free
engine's run of ``prompt + committed``; a block-paged replica's
heartbeat reads the pool's free blocks (the reference's raises). The
port's JSONL renders in
``scripts/telemetry_report.py``'s fabric section.

The module's torch ops run in one intra-op thread.
"""

import gc
import importlib.util
import weakref
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.serving as jserving
import deepspeed_tpu.telemetry as jtelemetry
import deepspeed_tpu.testing as jtesting
import deepspeed_tpu_torch
import deepspeed_tpu_torch.serving as tserving
import deepspeed_tpu_torch.telemetry as ttelemetry
import deepspeed_tpu_torch.testing as ttesting
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.inference.weights import gpt2_params_from_numpy
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """torch's intra-op team cut to one thread for the module (its ops are
    tiny; on a loaded host each op's thread barrier cost more than the
    op), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _side(pkg, testing, telemetry, eng, vocab):
    return SimpleNamespace(S=pkg, T=testing, M=telemetry, eng=eng,
                           vocab=vocab)


@pytest.fixture(scope="module")
def sides():
    """(jax side, port side): one tiny GPT-2 InferenceEngine each, the
    port's on the JAX engine's weights. The reference engine is dropped at
    teardown."""
    groups.reset()
    jeng = deepspeed_tpu.init_inference(JGPT2Model(JGPT2Config.tiny()),
                                        dtype="fp32", max_out_tokens=128)
    params = gpt2_params_from_numpy(jax.device_get(jeng.params), "cpu")
    teng = deepspeed_tpu_torch.init_inference(
        GPT2Model(GPT2Config.tiny()), dtype="fp32", max_out_tokens=128,
        device="cpu", params=params)
    vocab = GPT2Config.tiny().vocab_size
    assert vocab == JGPT2Config.tiny().vocab_size
    out = (_side(jserving, jtesting, jtelemetry, jeng, vocab),
           _side(tserving, ttesting, ttelemetry, teng, vocab))
    yield out
    del out, jeng, teng
    gc.collect()


# ------------------------------------------------------------ scenario kit
def _serving(s, clock, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("buckets", (16, 64))
    kw.setdefault("telemetry", False)
    return s.S.ServingEngine(s.eng, time_fn=clock.time, **kw)


def _factory(s, clock, inj=None, chaos_for=(), engine_kw=None):
    def factory(name):
        chaos = inj.replica_plan(name) \
            if inj is not None and name in chaos_for else None
        return s.S.InProcessReplica(name, _serving(s, clock,
                                                   **(engine_kw or {})),
                                    chaos=chaos, clock=clock)
    return factory


def _requests(s, specs):
    """Requests of one side from (rid, prompt, max_new, arrival, kw)."""
    return [s.S.Request(rid=rid, prompt=list(p), max_new_tokens=n,
                        arrival_time=t, **kw)
            for rid, p, n, t, kw in specs]


def _specs(trace):
    return [(r.rid, [int(v) for v in r.prompt], r.max_new_tokens,
             float(r.arrival_time), {"priority": r.priority})
            for r in trace]


def _bimodal_specs(s, n=14, seed=0):
    return _specs(s.S.bimodal_trace(
        np.random.RandomState(seed), n, rate=200.0, short_lens=(4, 6, 8),
        long_lens=(24,), long_frac=0.25, short_new=(6, 8), long_new=(6,),
        vocab_size=s.vocab))


def _oracle(s, specs):
    """Fault-free single-replica greedy run — the chaos oracle."""
    clock = s.T.FakeClock(auto_dt=0.001)
    return {r.rid: r.tokens
            for r in _serving(s, clock).run(_requests(s, specs))}


def _results(results):
    return sorted((r.rid, list(r.tokens), [float(t) for t in r.token_times],
                   r.finish_reason, float(r.finish_time), r.failovers,
                   r.replica, r.prompt_len) for r in results)


def _counters(router):
    return {k: getattr(router, k) for k in (
        "dispatches", "failovers", "retries", "timeouts", "shed_overload",
        "shed_deadline", "replica_crashes", "replica_restarts",
        "quarantines", "completed", "replicas_added", "replicas_removed",
        "drain_redispatches")}


def _breakers(router):
    return {n: (b.state, b.consecutive_failures, b.opened_at, b.trips,
                b.recoveries) for n, b in sorted(router.breakers.items())}


def _fabric_metrics(reg):
    snap = reg.snapshot()
    return ({k: v for k, v in snap["counters"].items()
             if k.startswith("fabric/")},
            {k: v for k, v in snap["gauges"].items()
             if k.startswith("fabric/")},
            {k: v["count"] for k, v in snap["histograms"].items()
             if k.startswith("fabric/")})


def _both(sides, scenario):
    """Run ``scenario(side)`` on both packages; the port's result is
    returned after its comparable record equals the reference's."""
    js, ts = sides
    want, _ = scenario(js)
    got, extra = scenario(ts)
    for key in want:
        assert got[key] == want[key], f"{key}: port {got[key]} != jax " \
                                      f"{want[key]}"
    return got, extra


def _report_module():
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", ROOT / "scripts" / "telemetry_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ fault seams
def test_replica_fault_plans_match_jax():
    """The scripted seams raise the same typed errors at the same calls
    and stall the clock alike; alert storms pop the same transitions."""
    logs = []
    for T, errs in ((jtesting, jserving), (ttesting, tserving)):
        inj = T.FaultInjector()
        inj.crash_replica_step("a", 4)
        inj.flaky_replica_step("a", 2, count=2)
        inj.straggle_replica("a", 0.5, from_step=2, until_step=3)
        inj.fail_replica_probes("a", count=2)
        clock = T.FakeClock()
        plan, log = inj.replica_plan("a"), []
        for _ in range(6):
            try:
                plan.on_step(clock)
                log.append(("ok", clock.now))
            except T.SimulatedCrash:
                log.append(("crash", clock.now))
            except errs.TransientReplicaError:
                log.append(("transient", clock.now))
        for _ in range(3):
            try:
                plan.on_probe()
                log.append("probe ok")
            except errs.TransientReplicaError:
                log.append("probe failed")
        inj.alert_storm(start_s=0.1, count=3, period_s=0.2, severity="page")
        inj.alert_storm(start_s=0.15, count=2, period_s=0.1, flap=False,
                        rule="other", severity="warn")
        for now in (0.05, 0.3, 0.6, 1.0):
            log.append([(a.t, a.rule, a.severity, a.kind, a.sli)
                        for a in inj.due_alerts(now)])
        logs.append(log)
    assert logs[1] == logs[0]
    assert ("crash", 1.0) in logs[1]


# -------------------------------------------------------- circuit breaker
BREAKER_SCRIPTS = {
    "reference": [("fail", 0.0), ("fail", 0.1), ("fail", 0.2),
                  ("allow", 0.5), ("allow", 1.3), ("allow", 1.3),
                  ("fail", 1.3), ("allow", 2.4), ("ok", 2.4), ("fail", 2.5),
                  ("ok", 2.6), ("fail", 2.7), ("fail", 2.8)],
    "trip_and_quarantine": [("fail", 0.0), ("trip", 0.1), ("trip", 0.2),
                            ("fail", 0.4), ("allow", 1.0), ("allow", 1.5),
                            ("fail", 1.5), ("allow", 2.0), ("allow", 2.6),
                            ("ok", 2.6), ("ok", 2.7)],
}


@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_circuit_breaker_transitions_match_jax(script):
    trails = []
    for S in (jserving, tserving):
        b = S.CircuitBreaker(failure_threshold=3, cooldown_s=1.0)
        trail = []
        for op, t in BREAKER_SCRIPTS[script]:
            ret = {"fail": b.record_failure, "ok": b.record_success,
                   "allow": b.allow_probe, "trip": b.trip}[op](t)
            trail.append((ret, b.state, b.consecutive_failures, b.opened_at,
                          b.trips, b.recoveries, b.dispatchable))
        trails.append(trail)
    assert trails[1] == trails[0]
    with pytest.raises(tserving.EngineConfigError):
        tserving.CircuitBreaker(failure_threshold=0)


# ------------------------------------------------------------ supervisor
def _sup_budget(S):
    sup = S.ReplicaSupervisor(max_restarts=2, restart_delay_s=0.5,
                              backoff_factor=2.0, jitter=0.0)
    out = [sup.on_failure("r0", t) for t in (10.0, 11.0, 13.0, 99.0)]
    sup2 = S.ReplicaSupervisor(max_restarts=1, restart_delay_s=0.5,
                               backoff_factor=2.0, jitter=0.0)
    out.append(sup2.on_failure("r1", 0.0))
    out += [sup2.on_failure("r1", float(k), restartable=True)
            for k in range(10)]
    out += [sup2.on_failure("r1", 20.0), sup2.on_failure("r2", 20.0)]
    return out, [(n, s.restarts(n), s.preemption_restarts(n),
                  s.is_abandoned(n)) for s in (sup, sup2)
                 for n in ("r0", "r1", "r2")]


def _sup_window(S):
    sup = S.ReplicaSupervisor(max_restarts=1, restart_window_s=10.0,
                              restart_delay_s=0.5, backoff_factor=2.0,
                              jitter=0.0)
    out = [sup.on_failure("r0", 0.0), sup.on_failure("r0", 11.0),
           sup.on_failure("r0", 12.0)]
    sup3 = S.ReplicaSupervisor(max_preemption_restarts=2,
                               restart_delay_s=0.0)
    out += [sup3.on_failure("r1", t, restartable=True)
            for t in (0.0, 1.0, 2.0)]
    return out, [sup.is_abandoned("r0"), sup3.is_abandoned("r1")]


def _sup_jitter_rebase(S):
    import random

    sup = S.ReplicaSupervisor(max_restarts=5, restart_window_s=5.0,
                              restart_delay_s=0.1, jitter=0.3,
                              rng=random.Random(7))
    out = [sup.on_failure("r0", t) for t in (0.0, 0.5, 1.0)]
    sup.rebase(4.0)            # a new run re-anchors the offset clock
    out += [sup.on_failure("r0", t) for t in (0.2, 7.0)]
    out.append(sup.on_failure("r1", 0.3, restartable=True))
    return out, [sup.restarts("r0"), sup.is_abandoned("r0")]


SUPERVISOR_SCENARIOS = {"budget_backoff_restartable": _sup_budget,
                        "rolling_window_and_preemption_cap": _sup_window,
                        "jitter_and_rebase": _sup_jitter_rebase}


@pytest.mark.parametrize("scenario", sorted(SUPERVISOR_SCENARIOS))
def test_supervisor_decisions_match_jax(scenario):
    fn = SUPERVISOR_SCENARIOS[scenario]
    assert fn(tserving) == fn(jserving)


# --------------------------------------------------------------- chaos pins
def test_chaos_bimodal_crash_with_resurrection_matches_jax(sides, tmp_path):
    """The reference's acceptance pin on both sides: a 3-replica fabric
    on the bimodal trace, r1 crashing at its 3rd step, supervised
    resurrection. Results, counters, breakers and the registry's fabric
    metrics equal the reference's; every request completes with the
    fault-free run's tokens; the port's JSONL renders in the report's
    fabric section."""
    def scenario(s):
        specs = _bimodal_specs(s)
        clock = s.T.FakeClock(auto_dt=0.001)
        inj = s.T.FaultInjector()
        inj.crash_replica_step("r1", 3)
        factory = _factory(s, clock, inj, chaos_for=("r1",))
        reg = s.M.MetricsRegistry()
        router = s.S.FabricRouter(
            [factory(n) for n in ("r0", "r1", "r2")],
            replica_factory=factory,
            supervisor=s.S.ReplicaSupervisor(max_restarts=3,
                                             restart_delay_s=0.05,
                                             jitter=0.0),
            time_fn=clock.time, telemetry=reg, heartbeat_interval_s=0.05)
        results = router.run(_requests(s, specs))
        return ({"specs": specs, "results": _results(results),
                 "counters": _counters(router), "breakers": _breakers(router),
                 "metrics": _fabric_metrics(reg),
                 "recompiles": router.recompile_count()},
                (router, reg, results, _oracle(s, specs)))

    got, (router, reg, results, oracle) = _both(sides, scenario)
    assert len(results) == 14 and router.replica_crashes == 1
    assert router.failovers >= 1 and router.replica_restarts == 1
    for r in results:
        assert r.finish_reason in ("eos", "length")
        assert r.tokens == oracle[r.rid]
    assert any(r.failovers > 0 for r in results)
    assert got["recompiles"] == 0

    path = str(tmp_path / "fabric.jsonl")
    reg.attach_sink(ttelemetry.JsonlSink(path))
    reg.flush(step=1)
    reg.sink.close()
    mod = _report_module()
    records, n_bad = mod.load_records(path)
    agg = mod.aggregate(records, n_bad_lines=n_bad)
    assert agg["fabric"]["failovers"] == router.failovers
    assert agg["fabric"]["replica_crashes"] == 1
    assert agg["fabric"]["failover_latency_ms"]["count"] >= 1
    assert "fabric" in mod.render(agg)


def test_chaos_bursty_crash_without_supervisor_matches_jax(sides):
    def scenario(s):
        specs = _specs(s.S.bursty_poisson_trace(
            np.random.RandomState(1), 12, burst_size=4, burst_rate=50.0,
            prompt_lens=(4, 6, 8), max_new_choices=(6, 8),
            vocab_size=s.vocab, priorities=(0, 1)))
        clock = s.T.FakeClock(auto_dt=0.001)
        inj = s.T.FaultInjector()
        inj.crash_replica_step("r0", 2)
        factory = _factory(s, clock, inj, chaos_for=("r0",))
        router = s.S.FabricRouter([factory(n) for n in ("r0", "r1", "r2")],
                                  time_fn=clock.time, telemetry=False)
        results = router.run(_requests(s, specs))
        return ({"specs": specs, "results": _results(results),
                 "counters": _counters(router),
                 "breakers": _breakers(router)},
                (router, results, _oracle(s, specs)))

    _, (router, results, oracle) = _both(sides, scenario)
    assert router.replica_crashes == 1 and router.replica_restarts == 0
    for r in results:
        assert r.tokens == oracle[r.rid] and r.replica in ("r1", "r2")
    assert router.recompile_count() == 0


def test_failover_stream_equals_result_tokens_as_jax(sides):
    """Idempotency: the client's stream across crash + failover is
    exactly RequestResult.tokens, on both sides."""
    def scenario(s):
        streamed = {}

        def cb(rid):
            streamed[rid] = []
            return lambda t: streamed[rid].append(t)

        specs = [(i, [7 + i, 11, 13 + i, 17], 8, 0.0, {}) for i in range(6)]
        reqs = _requests(s, specs)
        for r in reqs:
            r.on_token = cb(r.rid)
        clock = s.T.FakeClock(auto_dt=0.001)
        inj = s.T.FaultInjector()
        inj.crash_replica_step("r0", 2)
        factory = _factory(s, clock, inj, chaos_for=("r0",))
        router = s.S.FabricRouter([factory(n) for n in ("r0", "r1")],
                                  time_fn=clock.time, telemetry=False)
        results = router.run(reqs)
        return ({"results": _results(results), "streamed": streamed,
                 "counters": _counters(router)},
                (router, results, streamed, _oracle(s, specs)))

    _, (router, results, streamed, oracle) = _both(sides, scenario)
    assert router.failovers >= 1
    for r in results:
        assert streamed[r.rid] == r.tokens == oracle[r.rid]


def test_straggler_timeout_matches_jax(sides):
    def scenario(s):
        specs = [(0, [3, 5, 7], 6, 0.0, {}), (1, [4, 6, 8], 6, 8.0, {})]
        clock = s.T.FakeClock(auto_dt=0.001)
        inj = s.T.FaultInjector()
        inj.straggle_replica("r0", 2.0)
        factory = _factory(s, clock, inj, chaos_for=("r0",))
        router = s.S.FabricRouter(
            [factory(n) for n in ("r0", "r1")], time_fn=clock.time,
            telemetry=False, request_timeout_s=0.5, retry_base_delay_s=0.01,
            breaker_cooldown_s=1e6, failure_threshold=2)
        results = router.run(_requests(s, specs))
        return ({"results": _results(results), "counters": _counters(router),
                 "breakers": _breakers(router)},
                (router, results, _oracle(s, specs)))

    _, (router, results, oracle) = _both(sides, scenario)
    assert router.timeouts >= 2 and router.breakers["r0"].state == "open"
    for r in results:
        assert r.tokens == oracle[r.rid] and r.replica == "r1"


def test_flaky_steps_trip_breaker_and_recover_as_jax(sides):
    def scenario(s):
        specs = [(i, [2 + i, 9, 4], 6, 0.0 if i < 3 else 1.2 + 0.1 * i, {})
                 for i in range(6)]
        clock = s.T.FakeClock(auto_dt=0.001)
        inj = s.T.FaultInjector()
        inj.flaky_replica_step("r0", nth=1, count=3)
        factory = _factory(s, clock, inj, chaos_for=("r0",))
        router = s.S.FabricRouter(
            [factory(n) for n in ("r0", "r1")], time_fn=clock.time,
            telemetry=False, failure_threshold=3, breaker_cooldown_s=0.3,
            heartbeat_interval_s=0.05, retry_base_delay_s=0.01)
        results = router.run(_requests(s, specs))
        return ({"results": _results(results), "counters": _counters(router),
                 "breakers": _breakers(router)},
                (router, results, _oracle(s, specs)))

    _, (router, results, oracle) = _both(sides, scenario)
    assert router.quarantines >= 1
    assert router.breakers["r0"].state == "closed"
    for r in results:
        assert r.tokens == oracle[r.rid]
    assert router.recompile_count() == 0


def test_flight_recorder_triggers_match_jax(sides):
    """The router's incident triggers (replica crash, quarantine, an
    overload shed burst) fire at the same instants with the same context
    on both sides: a flaky r0 quarantined, a crash of r1, and a bounded
    queue overflowing into sheds."""
    def scenario(s):
        specs = _bimodal_specs(s, n=14, seed=2)
        clock = s.T.FakeClock(auto_dt=0.001)
        inj = s.T.FaultInjector()
        inj.flaky_replica_step("r0", nth=2, count=3)
        inj.crash_replica_step("r1", 4)
        factory = _factory(s, clock, inj, chaos_for=("r0", "r1"))
        reg = s.M.MetricsRegistry()
        rec = s.M.FlightRecorder(registry=reg)
        router = s.S.FabricRouter(
            [factory(n) for n in ("r0", "r1", "r2")], time_fn=clock.time,
            telemetry=reg, flight_recorder=rec, max_queue=4,
            max_dispatch_depth=2, shed_burst_threshold=2,
            heartbeat_interval_s=0.05)
        results = router.run(_requests(s, specs))
        return ({"dumps": [(d["reason"], d["context"]) for d in rec.dumps],
                 "results": _results(results),
                 "counters": _counters(router)}, None)

    got, _ = _both(sides, scenario)
    reasons = {r for r, _ in got["dumps"]}
    assert {"replica_crash", "replica_quarantine",
            "overload_shed_burst"} <= reasons, got["dumps"]


# ---------------------------------------------------- graceful degradation
def test_bounded_queue_sheds_lowest_class_first_as_jax(sides):
    def scenario(s):
        clock = s.T.FakeClock()
        router = s.S.FabricRouter([_factory(s, clock)("r0")],
                                  time_fn=clock.time, telemetry=False,
                                  max_queue=2, max_dispatch_depth=0)
        for rid, prio in ((0, 2), (1, 1), (2, 0)):
            router.submit(s.S.Request(rid=rid, prompt=[1], max_new_tokens=1,
                                      priority=prio), now=0.0)
        shed = router.step(0.0)
        with pytest.raises(s.S.RouterOverloadedError):
            router.submit(s.S.Request(rid=3, prompt=[1], max_new_tokens=1,
                                      priority=1), now=0.0)
        return ({"shed": _results(shed), "counters": _counters(router),
                 "queue": [tr.request.rid for tr in router._queue]}, None)

    got, _ = _both(sides, scenario)
    assert [r[0] for r in got["shed"]] == [0]
    assert got["shed"][0][3] == "shed_overload"


def test_expired_deadline_shed_before_prefill_as_jax(sides):
    def scenario(s):
        clock = s.T.FakeClock(auto_dt=0.001)
        replica = _factory(s, clock)("r0")
        router = s.S.FabricRouter([replica], time_fn=clock.time,
                                  telemetry=False)
        results = router.run(_requests(
            s, [(i, [5, 6, 7], 4, 0.5, {"deadline": 0.1})
                for i in range(3)]))
        return ({"results": _results(results), "counters": _counters(router),
                 "prefills": replica.serving.prefill_calls}, None)

    got, _ = _both(sides, scenario)
    assert [r[3] for r in got["results"]] == ["shed_deadline"] * 3
    assert got["prefills"] == 0


def test_engine_side_deadline_shed_accounted_as_jax(sides):
    """A deadline that expires inside a replica's queue is shed by the
    engine before prefill, and the router counts it as a shed."""
    def scenario(s):
        clock = s.T.FakeClock(auto_dt=0.001)
        factory = _factory(s, clock, engine_kw={"num_slots": 1})
        router = s.S.FabricRouter([factory("r0")], time_fn=clock.time,
                                  telemetry=False)
        results = router.run(_requests(
            s, [(0, [3, 4], 30, 0.0, {}),
                (1, [5, 6], 4, 0.0, {"deadline": 0.01})]))
        return ({"results": _results(results), "counters": _counters(router)},
                None)

    got, _ = _both(sides, scenario)
    by_rid = {r[0]: r for r in got["results"]}
    assert by_rid[1][3] == "shed_deadline" and by_rid[1][1] == []
    assert got["counters"]["shed_deadline"] == 1
    assert got["counters"]["completed"] == 1


def test_router_run_is_reentrant_as_jax(sides):
    def scenario(s):
        clock = s.T.FakeClock(auto_dt=0.001)
        factory = _factory(s, clock)
        router = s.S.FabricRouter([factory(n) for n in ("r0", "r1")],
                                  time_fn=clock.time, telemetry=False,
                                  heartbeat_interval_s=0.05)
        res_a = router.run(_requests(
            s, [(i, [2 + i, 3], 4, 0.0, {}) for i in range(2)]))
        t_before_b = clock.now
        res_b = router.run(_requests(
            s, [(10 + i, [4 + i, 5], 4, 0.0, {}) for i in range(2)]))
        return ({"a": _results(res_a), "b": _results(res_b),
                 "last_hb": router._last_hb, "counters": _counters(router),
                 "duration_b": clock.now - t_before_b}, None)

    got, _ = _both(sides, scenario)
    assert 0.0 <= got["last_hb"] <= got["duration_b"]
    assert got["counters"]["completed"] == 4


def test_all_replicas_dead_fails_backlog_as_jax(sides):
    def scenario(s):
        clock = s.T.FakeClock(auto_dt=0.001)
        inj = s.T.FaultInjector()
        inj.crash_replica_step("r0", 1)
        router = s.S.FabricRouter(
            [_factory(s, clock, inj, chaos_for=("r0",))("r0")],
            time_fn=clock.time, telemetry=False)
        results = router.run(_requests(
            s, [(i, [4, 5], 4, 0.0, {}) for i in range(3)]))
        return ({"results": _results(results), "counters": _counters(router)},
                None)

    got, _ = _both(sides, scenario)
    assert [r[3] for r in got["results"]] == ["failed"] * 3
    assert got["counters"]["replica_crashes"] == 1


# ---------------------------------------------------------- port-only pins
def test_block_paged_probe_reads_the_free_blocks(sides):
    """A block-paged replica's heartbeat reports the pool's free blocks.
    The reference's probe calls ``cache.free_count()``, a property there
    too, so its block-paged heartbeat raises TypeError (its suites probe
    slot-paged replicas only); the port reads the property."""
    js, ts = sides
    kw = dict(prefix_cache=True, block_size=16)
    jrep = js.S.InProcessReplica("r0", _serving(js, js.T.FakeClock(), **kw))
    with pytest.raises(TypeError):
        jrep.probe(0.0)
    trep = ts.S.InProcessReplica("r0", _serving(ts, ts.T.FakeClock(), **kw))
    health = trep.probe(0.0)
    assert health.free_blocks == trep.serving.cache.free_count > 0
    assert (health.queue_depth, health.free_slots, health.pending) == (0, 4, 0)


def test_device_errors_propagate_and_are_never_failed_over(sides):
    """Only the typed replica errors are the fabric's to handle: a
    RuntimeError from inside an engine's step (a CUDA error, a failed
    graph capture) leaves the router, with no crash counted."""
    _, s = sides
    clock = s.T.FakeClock(auto_dt=0.001)
    factory = _factory(s, clock)
    router = s.S.FabricRouter([factory(n) for n in ("r0", "r1")],
                              replica_factory=factory,
                              supervisor=s.S.ReplicaSupervisor(),
                              time_fn=clock.time, telemetry=False)

    def broken(now=None):
        raise RuntimeError("CUDA error: an illegal memory access")

    router.replicas["r0"].serving.step = broken
    with pytest.raises(RuntimeError, match="illegal memory access"):
        router.run(_requests(s, [(i, [3, 4, 5], 4, 0.0, {})
                                 for i in range(2)]))
    assert router.replica_crashes == 0 and router.failovers == 0


def test_crashed_and_retired_replicas_release_their_engines(sides):
    """A crashed replica drops its ServingEngine at the crash (the dead
    process's KV store and graphs), a drained one at its removal; both
    keep their recompile and decode-step counts."""
    _, s = sides
    clock = s.T.FakeClock(auto_dt=0.001)
    inj = s.T.FaultInjector()
    inj.crash_replica_step("r1", 3)
    factory = _factory(s, clock, inj, chaos_for=("r1",))
    first = {n: factory(n) for n in ("r0", "r1", "r2")}
    refs = {n: weakref.ref(r.serving) for n, r in first.items()}
    router = s.S.FabricRouter(list(first.values()), replica_factory=factory,
                              supervisor=s.S.ReplicaSupervisor(
                                  restart_delay_s=0.05, jitter=0.0),
                              time_fn=clock.time, telemetry=False)
    router.run(_requests(s, _bimodal_specs(s)))
    router.remove_replica("r2", drain=True)
    gc.collect()
    assert router.replica_crashes == 1
    assert first["r1"].serving is None and refs["r1"]() is None
    assert first["r1"].decode_steps > 0
    assert first["r2"].serving is None and refs["r2"]() is None
    assert refs["r0"]() is not None and router.recompile_count() == 0


def test_each_replica_owns_its_decode_graph_program(sides):
    """Departure of mechanism from the reference (whose replicas share
    one jit cache): each replica's ServingEngine wraps the inference
    engine's one decode program in a GraphProgram of its own over the
    engine's one graph pool, so every replica captures its own graph at
    warm-up on the card. The counting contract is the reference's: one
    entry per program per replica, no recompile."""
    _, s = sides
    built = []
    rep = s.S.run_twin(
        s.eng, s.S.synthetic_tenant_trace(
            5, s.vocab, tenants=[{"name": "web", "n": 8, "rate": 80.0}]),
        initial_replicas=3, replica_hook=built.append)
    decodes = [r.serving._decode for r in built]
    assert len({id(d) for d in decodes}) == len(built) == 3
    assert {id(d.program) for d in decodes} == {id(decodes[0].program)}
    assert {id(d.pool) for d in decodes} == {id(s.eng.graph_pool)}
    assert all(d._cache_size() == 1 for d in decodes)
    assert rep.recompiles == 0 and rep.served == 8


def test_bf16_failover_tail_equals_the_resumed_request_run(sides):
    """The bf16 hold of a failover: the tokens after the crash equal a
    fault-free engine's run of Request(prompt + committed, max_new -
    len(committed)) — the resumed request re-prefills its committed
    tokens, so its rounding is that run's, not the uninterrupted decode's.
    (fp32 runs are held to the uninterrupted stream above.)"""
    _, s = sides
    eng = deepspeed_tpu_torch.init_inference(
        GPT2Model(GPT2Config.tiny()), dtype="bf16", max_out_tokens=128,
        device="cpu", params=s.eng.params)
    b = SimpleNamespace(**{**vars(s), "eng": eng})
    specs = [(i, [7 + i, 11, 13 + i, 17, 19], 10, 0.0, {}) for i in range(4)]
    clock = b.T.FakeClock(auto_dt=0.001)
    inj = b.T.FaultInjector()
    inj.crash_replica_step("r0", 4)
    factory = _factory(b, clock, inj, chaos_for=("r0",))
    router = b.S.FabricRouter([factory("r0"), factory("r1")],
                              time_fn=clock.time, telemetry=False)
    committed = {}
    real = router._requeue

    def requeue(tr, now, *, crashed):
        committed[tr.request.rid] = list(tr.committed)
        return real(tr, now, crashed=crashed)

    router._requeue = requeue
    results = {r.rid: r for r in router.run(_requests(b, specs))}
    assert router.failovers >= 1 and any(committed.values())
    for rid, prefix in committed.items():
        _, prompt, n, _, _ = specs[rid]
        resumed = _oracle(b, [(rid, prompt + prefix, n - len(prefix), 0.0,
                               {})])[rid]
        assert results[rid].tokens == prefix + resumed
        assert results[rid].failovers == 1
