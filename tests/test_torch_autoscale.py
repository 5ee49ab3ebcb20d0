"""The port's elastic serving fabric (``FabricRouter.add_replica`` /
``remove_replica`` and the drains, the SLO-alert fan-out, the
``ElasticAutoscaler`` and the digital twin, serving/fabric/) held against
the JAX package's on the CPU.

Both packages serve the tiny GPT-2 in fp32 with the same weights (the JAX
engine's, carried over by the weight bridge), one module fixture per
package holding one ``InferenceEngine``. Each scenario of the JAX
package's ``tests/unit/serving/test_autoscale.py`` runs on both sides
with the same seeded trace and fault schedule on a ``FakeClock`` each,
and what it produces is held equal, exactly:

* pool membership, drains (graceful, on timeout, mid chunked prefill and
  mid speculation), the typed refusals, each result's tokens, instants,
  finish reason, ``failovers`` and ``replica``, the router's counters;
* the alert fan-out's subscribers and deliveries; every
  ``ElasticAutoscaler`` decision with its evidence, the suppressed count;
* every ``TwinReport`` field of the alert-storm, nominal and chaos
  scenarios (served / shed / failed, ``per_tenant``, tokens, the alert
  and scale timelines, pool sizes, drain durations, SLO attainment,
  recompiles, counters) and so its ``fingerprint()``; the same scenario
  twice gives one fingerprint; the chaos fleet's tokens equal a
  fault-free fixed pool's.

The port's twin JSONL renders in ``scripts/telemetry_report.py``'s fabric
and autoscaler sections. The module's torch ops run in one intra-op
thread.
"""

import gc
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.serving as jserving
import deepspeed_tpu.serving.fabric.autoscaler as jautoscaler
import deepspeed_tpu.telemetry.registry as jregistry
import deepspeed_tpu.telemetry.slo as jslo
import deepspeed_tpu.testing as jtesting
import deepspeed_tpu_torch
import deepspeed_tpu_torch.serving as tserving
import deepspeed_tpu_torch.serving.fabric.autoscaler as tautoscaler
import deepspeed_tpu_torch.telemetry.registry as tregistry
import deepspeed_tpu_torch.telemetry.slo as tslo
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
    out = tuple(SimpleNamespace(S=S, T=T, A=A, R=R, L=L, eng=e, vocab=vocab)
                for S, T, A, R, L, e in (
                    (jserving, jtesting, jautoscaler, jregistry, jslo, jeng),
                    (tserving, ttesting, tautoscaler, tregistry, tslo, teng)))
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


def _stream_trace(s, n, prompt_len, max_new, streamed):
    rng = np.random.RandomState(17)

    def cb(rid):
        streamed[rid] = []
        return lambda t: streamed[rid].append(t)

    return [s.S.Request(rid=i, prompt=[int(v) for v in rng.randint(
        1, s.vocab, size=prompt_len)], max_new_tokens=max_new,
        arrival_time=0.0, on_token=cb(i)) for i in range(n)]


def _plain(s, trace):
    return [s.S.Request(rid=r.rid, prompt=list(r.prompt),
                        max_new_tokens=r.max_new_tokens,
                        arrival_time=r.arrival_time) for r in trace]


def _oracle(s, trace, engine_kw=None):
    clock = s.T.FakeClock(auto_dt=0.001)
    return {r.rid: r.tokens for r in _serving(
        s, clock, **(engine_kw or {})).run(_plain(s, trace))}


def _results(results):
    return sorted((r.rid, list(r.tokens), [float(t) for t in r.token_times],
                   r.finish_reason, float(r.finish_time), r.failovers,
                   r.replica) for r in results)


def _counters(router):
    return {k: getattr(router, k) for k in (
        "dispatches", "failovers", "retries", "timeouts", "shed_overload",
        "shed_deadline", "replica_crashes", "replica_restarts",
        "quarantines", "completed", "replicas_added", "replicas_removed",
        "drain_redispatches")}


def _drain_all(router, clock, out, max_iters=200_000):
    for _ in range(max_iters):
        if not router._queue and not router._inflight \
                and not router._draining:
            return out
        out.extend(router.step(clock.time()))
    raise AssertionError("router failed to drain the scenario")


def _both(sides, scenario):
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


# -------------------------------------------------------- pool membership
def test_add_replica_warm_admission_gate_as_jax(sides):
    def scenario(s):
        clock = s.T.FakeClock(auto_dt=0.001)
        inj = s.T.FaultInjector()
        inj.fail_replica_probes("sick", count=3)
        factory = _factory(s, clock, inj, chaos_for=("sick",))
        router = s.S.FabricRouter([factory("r0")], replica_factory=factory,
                                  time_fn=clock.time, telemetry=False)
        log = [router.pool_size()]
        with pytest.raises(s.S.ReplicaAdmissionError):
            router.add_replica(factory("sick"))
        log += [router.pool_size(), "sick" in router.replicas]
        log.append(router.add_replica())
        log.append(router.pool_size())
        with pytest.raises(s.S.ReplicaAdmissionError):
            router.add_replica(factory("r0"))
        trace = _plain(s, _stream_trace(s, 4, 6, 4, {}))
        results = router.run(trace)
        return ({"log": log, "results": _results(results),
                 "counters": _counters(router),
                 "recompiles": router.recompile_count()},
                (results, _oracle(s, trace)))

    got, (results, oracle) = _both(sides, scenario)
    assert got["log"] == [1, 1, False, "scale-0", 2]
    assert {r.rid: r.tokens for r in results} == oracle
    assert got["recompiles"] == 0


def test_remove_last_replica_refused_and_unknown_typed_as_jax(sides):
    def scenario(s):
        clock = s.T.FakeClock(auto_dt=0.001)
        factory = _factory(s, clock)
        router = s.S.FabricRouter([factory("r0"), factory("r1")],
                                  time_fn=clock.time, telemetry=False)
        with pytest.raises(s.S.UnknownReplicaError):
            router.remove_replica("nope")
        router.remove_replica("r1", drain=True)
        members = sorted(router.replicas)
        with pytest.raises(s.S.LastReplicaError):
            router.remove_replica("r0")
        return ({"members": members, "pool": router.pool_size(),
                 "counters": _counters(router)}, None)

    got, _ = _both(sides, scenario)
    assert got["members"] == ["r0"] and got["pool"] == 1


def test_remove_replica_idempotent_while_draining_as_jax(sides):
    def scenario(s):
        clock = s.T.FakeClock(auto_dt=0.001)
        factory = _factory(s, clock)
        router = s.S.FabricRouter([factory(n) for n in ("r0", "r1")],
                                  time_fn=clock.time, telemetry=False)
        router.submit(s.S.Request(rid=0, prompt=[3, 5, 7],
                                  max_new_tokens=6), now=clock.time())
        out = list(router.step(clock.time()))
        busy = "r0" if router.replicas["r0"].pending else "r1"
        router.remove_replica(busy, drain=True)
        draining = list(router.draining)
        router.remove_replica(busy, drain=True)
        removed_while = router.replicas_removed
        _drain_all(router, clock, out)
        return ({"busy": busy, "draining": draining,
                 "removed_while": removed_while, "results": _results(out),
                 "members": sorted(router.replicas),
                 "counters": _counters(router)}, None)

    got, _ = _both(sides, scenario)
    assert got["draining"] == [got["busy"]] and got["removed_while"] == 0
    assert got["busy"] not in got["members"] and len(got["results"]) == 1


# ------------------------------------------------------------- drain paths
def _caught_mid(router, clock, out, name, want, iters):
    for _ in range(iters):
        out.extend(router.step(clock.time()))
        if want(router, name):
            return True
    return False


def _mid_prefill(router, name):
    srv = router.replicas[name].serving
    return srv.prefill_chunks > 0 and any(
        tr.replica == name and not tr.committed
        for tr in router._inflight.values())


def _mid_speculation(router, name):
    return any(tr.replica == name and len(tr.committed) >= 1
               for tr in router._inflight.values())


DRAINS = {
    # (engine kw, prompt len, max new, caught, iterations, drain timeout)
    "graceful_mid_chunked_prefill": ({"prefill_token_budget": 16}, 40, 6,
                                     _mid_prefill, 50, None),
    "timeout_mid_chunked_prefill": ({"prefill_token_budget": 16}, 40, 6,
                                    _mid_prefill, 50, 0.0),
    "timeout_mid_speculation": (
        {"speculative": dict(mode="ngram", k_buckets=(4,))}, 8, 10,
        _mid_speculation, 200, 0.0),
}


@pytest.mark.parametrize("case", sorted(DRAINS))
def test_drains_match_jax(sides, case):
    """remove_replica(drain=True) while r0 is mid chunked prefill or mid
    speculative decode: with full grace the member finishes its work;
    with a zero drain timeout its work is cancelled and resumes on r1 from
    the committed-token record. Either way the client's stream equals the
    result tokens and the fault-free run's."""
    engine_kw, plen, max_new, caught, iters, timeout = DRAINS[case]

    def scenario(s):
        streamed = {}
        trace = _stream_trace(s, 6, plen, max_new, streamed)
        clock = s.T.FakeClock(auto_dt=0.001)
        factory = _factory(s, clock, engine_kw=engine_kw)
        kw = {} if timeout is None else dict(retry_base_delay_s=0.0,
                                             retry_max_delay_s=0.0)
        router = s.S.FabricRouter([factory(n) for n in ("r0", "r1")],
                                  time_fn=clock.time, telemetry=False, **kw)
        for r in trace:
            router.submit(r, now=clock.time())
        out = []
        assert _caught_mid(router, clock, out, "r0", caught, iters)
        committed = {tr.request.rid: list(tr.committed)
                     for tr in router._inflight.values()
                     if tr.replica == "r0"}
        if timeout is None:
            router.remove_replica("r0", drain=True)
            draining = list(router.draining)
        else:
            router.remove_replica("r0", drain=True, drain_timeout_s=timeout)
            draining = list(router.draining)
        _drain_all(router, clock, out)
        return ({"committed": committed, "draining": draining,
                 "results": _results(out), "streamed": streamed,
                 "members": sorted(router.replicas),
                 "counters": _counters(router),
                 "recompiles": router.recompile_count()},
                (out, streamed, _oracle(s, trace, engine_kw)))

    got, (out, streamed, oracle) = _both(sides, scenario)
    assert got["members"] == ["r1"] and len(out) == 6
    assert got["draining"] == (["r0"] if timeout is None else [])
    if timeout is None:
        assert got["counters"]["drain_redispatches"] == 0
    else:
        assert got["counters"]["drain_redispatches"] >= 1
    by_rid = {r.rid: r for r in out}
    for rid, prefix in got["committed"].items():
        assert by_rid[rid].tokens[:len(prefix)] == prefix
    for r in out:
        assert streamed[r.rid] == r.tokens == oracle[r.rid]
        assert r.finish_reason in ("eos", "length")
    assert got["recompiles"] == 0


# ------------------------------------------------------------ alert fan-out
def _alert(L, rule="fabric_queue:page:3x", severity="page", kind="fired",
           t=1.0):
    return L.SLOAlert(rule=rule, sli="fabric_queue", severity=severity,
                      kind=kind, t=t, burn_short=9.0, burn_long=9.0,
                      budget_consumed=0.5)


def test_alert_fanout_and_autosubscription_as_jax(sides):
    """One raising subscriber starves no other; the router subscribes the
    supervisor at construction and the autoscaler when it attaches."""
    def scenario(s):
        reg = s.R.MetricsRegistry()
        clock = s.T.FakeClock(auto_dt=0.001)
        slo = s.L.SLOEngine(registry=reg, time_fn=clock.time)
        sup = s.S.ReplicaSupervisor()
        got = []

        def poisoned(alert):
            raise RuntimeError("subscriber bug")

        for cb in (poisoned, got.append, sup.on_slo_alert, got.append):
            slo.add_alert_callback(cb)
        log = [len(slo._callbacks)]
        slo.inject_alert(_alert(s.L))
        slo.inject_alert(_alert(s.L, kind="resolved", t=2.0))
        log += [[a.kind for a in got], [a.kind for a in sup.slo_alerts]]
        slo.remove_alert_callback(poisoned)
        slo.set_alert_callback(got.append)
        slo.inject_alert(_alert(s.L, t=3.0))
        log += [len(got), len(sup.slo_alerts)]

        slo2 = s.L.SLOEngine(registry=reg, time_fn=clock.time)
        sup2 = s.S.ReplicaSupervisor()
        factory = _factory(s, clock)
        router = s.S.FabricRouter([factory("r0")], replica_factory=factory,
                                  time_fn=clock.time, telemetry=reg,
                                  supervisor=sup2, slo=slo2)
        scaler = s.A.ElasticAutoscaler(router, max_replicas=2)
        log.append([sup2.on_slo_alert in slo2._callbacks,
                    scaler.on_slo_alert in slo2._callbacks])
        slo2.inject_alert(_alert(s.L))
        log += [len(sup2.slo_alerts), sorted(scaler._firing_pages)]
        slo2.inject_alert(_alert(s.L, kind="resolved", t=2.0))
        log += [sorted(scaler._firing_pages), scaler.alerts_seen]
        return {"log": log}, None

    got, _ = _both(sides, scenario)
    assert got["log"][:3] == [3, ["fired", "resolved"], ["fired", "resolved"]]
    assert got["log"][5] == [True, True]


# --------------------------------------------------------- autoscaler policy
@pytest.mark.parametrize("kw", [dict(min_replicas=0),
                                dict(min_replicas=4, max_replicas=2),
                                dict(queue_high=4, queue_low=4)],
                         ids=["min_zero", "max_below_min", "empty_band"])
def test_autoscaler_config_validation_typed_as_jax(sides, kw):
    msgs = []
    for s in sides:
        clock = s.T.FakeClock(auto_dt=0.001)
        factory = _factory(s, clock)
        router = s.S.FabricRouter([factory("r0")], replica_factory=factory,
                                  time_fn=clock.time, telemetry=False)
        with pytest.raises(s.S.EngineConfigError) as e:
            s.A.ElasticAutoscaler(router, **kw)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_autoscaler_cooldown_budget_and_hysteresis_as_jax(sides):
    def scenario(s):
        clock = s.T.FakeClock(auto_dt=0.001)
        factory = _factory(s, clock)
        router = s.S.FabricRouter([factory("r0")], replica_factory=factory,
                                  time_fn=clock.time, telemetry=False)
        scaler = s.A.ElasticAutoscaler(
            router, min_replicas=1, max_replicas=4,
            scale_out_cooldown_s=0.5, scale_in_cooldown_s=0.5,
            idle_stable_s=1.0, max_scale_events=2, scale_window_s=100.0)
        scaler.on_slo_alert(_alert(s.L))
        ticks = [scaler.tick(t) for t in (0.0, 0.1, 0.6, 1.2)]
        scaler.on_slo_alert(_alert(s.L, kind="resolved", t=2.0))
        ticks += [scaler.tick(t) for t in (200.0, 200.5, 201.1)]
        return ({"ticks": [None if d is None else
                           (d.action, d.t, d.reason, d.replica,
                            d.pool_before, d.pool_after, d.evidence)
                           for d in ticks],
                 "suppressed": scaler.suppressed,
                 "pool": router.pool_size(),
                 "members": sorted(router.replicas)}, None)

    got, _ = _both(sides, scenario)
    actions = [t and t[0] for t in got["ticks"]]
    assert actions == ["scale_out", None, "scale_out", None, None, None,
                       "scale_in"]
    assert got["suppressed"] == 2 and got["pool"] == 2
    assert got["ticks"][0][6]["firing_pages"] == ["fabric_queue:page:3x"]


# ----------------------------------------------------------------- the twin
def _chaos_trace(s):
    tenants = [
        {"name": "bots", "kind": "bursty", "n": 60, "rate": 2000.0,
         "burst_size": 60, "prompt_lens": (4, 12), "max_new": (6, 10)},
        {"name": "web", "kind": "bimodal", "n": 12, "rate": 100.0,
         "short_lens": (4, 8), "long_lens": (12, 16), "long_frac": 0.3,
         "short_new": (4, 6), "long_new": (8, 12)},
    ]
    trace = s.S.synthetic_tenant_trace(7, s.vocab, tenants=tenants)
    tail_t = max(r.arrival_time for r in trace) + 6.0
    rng = np.random.RandomState(99)
    for k in range(2):
        trace.append(s.S.Request(
            rid=len(trace),
            prompt=[int(v) for v in rng.randint(1, s.vocab, size=6)],
            max_new_tokens=4, arrival_time=tail_t + 0.2 * k))
    trace.sort(key=lambda r: (r.arrival_time, r.rid))
    for i, r in enumerate(trace):
        r.rid = i
    return trace


_CHAOS_AK = dict(min_replicas=1, max_replicas=6, scale_out_cooldown_s=0.3,
                 scale_in_cooldown_s=1.5, idle_stable_s=0.5,
                 queue_high=10_000, queue_low=0)
_CHAOS_FAULTS = ({"kind": "crash", "replica": "r0", "at_step": 40},
                 {"kind": "crash", "replica": "r1", "at_step": 55})
_STORM_AK = dict(min_replicas=1, max_replicas=3, scale_out_cooldown_s=0.2,
                 scale_in_cooldown_s=1.0, idle_stable_s=0.5,
                 max_scale_events=3, scale_window_s=60.0)
_STORM = ({"kind": "alert_storm", "start_s": 0.02, "count": 20,
           "period_s": 0.1, "severity": "page", "flap": True},)


def _nominal(s):
    tenants = [{"name": "web", "kind": "bimodal", "n": 10, "rate": 40.0},
               {"name": "batch", "kind": "bursty", "n": 6, "rate": 30.0,
                "burst_size": 2}]
    return (s.S.synthetic_tenant_trace(11, s.vocab, tenants=tenants),
            dict(initial_replicas=2, autoscaler_kw=dict(max_replicas=4)))


def _storm(s):
    tenants = [{"name": "web", "kind": "bimodal", "n": 10, "rate": 50.0}]
    return (s.S.synthetic_tenant_trace(3, s.vocab, tenants=tenants),
            dict(initial_replicas=1, autoscaler_kw=_STORM_AK,
                 faults=_STORM))


def _chaos(s):
    return (_chaos_trace(s), dict(initial_replicas=2,
                                  autoscaler_kw=_CHAOS_AK,
                                  faults=_CHAOS_FAULTS))


TWINS = {"nominal": _nominal, "alert_storm": _storm, "chaos": _chaos}


@pytest.fixture(scope="module")
def port_chaos(sides, tmp_path_factory):
    """The port's chaos twin run once, its JSONL teed to a file: (report,
    path)."""
    _, s = sides
    path = str(tmp_path_factory.mktemp("twin") / "twin.jsonl")
    trace, kw = _chaos(s)
    return s.S.run_twin(s.eng, trace, jsonl_path=path, **kw), path


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_reports_equal_jax(sides, port_chaos, name):
    """Every TwinReport field equals the reference's (so the fingerprint
    does); the scenario's own pins as the reference states them."""
    reports = []
    for s in sides:
        trace, kw = TWINS[name](s)
        if name == "chaos" and s is sides[1]:
            reports.append(port_chaos[0])
        else:
            reports.append(s.S.run_twin(s.eng, trace, **kw))
    want, got = (r.to_json() for r in reports)
    for field in want:
        assert got[field] == want[field], field
    assert reports[1].fingerprint() == reports[0].fingerprint()
    rep, n = reports[1], len(TWINS[name](sides[1])[0])
    assert rep.served == n and rep.failed == 0 and rep.recompiles == 0
    if name == "nominal":
        assert rep.scale_timeline == [] and rep.alert_timeline == []
        assert rep.pool_sizes == [(0.0, 2)] and rep.shed == 0
    elif name == "alert_storm":
        outs = [d for d in rep.scale_timeline if d[1] == "scale_out"]
        assert 1 <= len(outs) <= 3
        assert max(p for _, p in rep.pool_sizes) <= 3
    else:
        outs = [d for d in rep.scale_timeline if d[1] == "scale_out"]
        ins = [d for d in rep.scale_timeline if d[1] == "scale_in"]
        assert outs and outs[0][2] == "page_burn" and ins
        assert rep.counters["replica_crashes"] == 2
        assert rep.counters["replica_restarts"] >= 1
        assert rep.counters["failovers"] >= 1
        assert rep.drain_durations_ms and rep.shed == 0


def test_twin_chaos_replays_and_matches_a_fixed_pool(sides, port_chaos):
    """The chaos fleet twice gives one fingerprint, and its tokens equal a
    fault-free fixed pool of the autoscaler's ceiling."""
    _, s = sides
    trace, kw = _chaos(s)
    rep = port_chaos[0]
    rep2 = s.S.run_twin(s.eng, trace, **kw)
    assert rep.fingerprint() == rep2.fingerprint()
    oracle = s.S.run_twin(s.eng, _chaos(s)[0],
                          initial_replicas=_CHAOS_AK["max_replicas"],
                          autoscaler_kw=None, faults=())
    assert oracle.shed == 0 and oracle.failed == 0
    assert rep.tokens == oracle.tokens
    assert sum(t["served"] for t in rep.per_tenant.values()) == rep.served


def test_twin_jsonl_renders_fabric_and_autoscaler_sections(port_chaos):
    """The port's twin stream is telemetry_report's input: the autoscaler
    section carries every decision with its evidence, the pool-size
    series and drain percentiles, past a torn line; the fabric section
    the router's counters."""
    rep, path = port_chaos
    with open(path, "ab") as f:
        f.write(b'{"kind": "event", "name": "fabric/auto')
    mod = _report_module()
    records, bad = mod.load_records(path)
    assert bad == 1
    agg = mod.aggregate(records, n_bad_lines=bad)
    asc = agg["autoscaler"]
    assert len(asc["decisions"]) == len(rep.scale_timeline)
    first = asc["decisions"][0]
    assert first["action"] == "scale_out" and first["reason"] == "page_burn"
    assert "queue_depth" in first["evidence"]
    assert [n for _, n in asc["pool_size_series"]] == \
        [p for _, p in rep.pool_sizes[1:]]
    assert asc["drain_ms"]["count"] == len(rep.drain_durations_ms)
    assert asc["autoscale_out"] >= 1 and asc["replicas_removed"] >= 1
    assert agg["fabric"]["failovers"] == rep.counters["failovers"]
    assert agg["fabric"]["replica_crashes"] == 2
    text = mod.render(agg)
    assert "autoscaler decisions" in text and "page_burn" in text
    assert "fabric" in text
