"""The serving control plane of the port (telemetry/slo.py, tenants.py,
flight_recorder.py; ``ServingEngine(slo=..., tenants=...)`` and the prefix
cache's counters) held against the JAX package on the CPU.

* SLO engine: the same scripted sample streams on the same clock through
  both packages' engines give equal windows, burn rates, budgets, firing
  sets and fired/resolved timelines (window math, multi-window rules,
  ``min_events``, availability and gauge SLIs, a replay, subscribers);
  ``validate_slo_config`` lists the reference's errors word for word.
* Tenant ledger and flight recorder: equal totals; the recorder's rings,
  tee, dump payload (its metric snapshot's timestamp aside), cooldown and
  page-alert dump as the reference's.
* Serving: the tiny LLaMA in fp32 (the JAX engine's weights) on one seeded
  trace and a virtual clock, slot-paged with chunked prefill and swap
  preemption, and block-paged with the prefix cache, both engines armed
  with ``slo=`` (a TTFT latency SLI that fires and an availability SLI),
  ``tenants=True`` (one tenant per class) and a span tracer: the tokens
  equal the reference's and the port's bare engine's bit for bit; the
  per-tenant totals, the alert timeline and the prefix hit, miss, COW and
  eviction counters equal the reference's exactly; the tenants' token
  totals sum to the engine's counters.
* ``scripts/telemetry_report.py`` renders the port's JSONL (SLO, tenants,
  attribution) and a flight dump (postmortem).
"""

import dataclasses
import importlib.util
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.telemetry as jt
import deepspeed_tpu_torch
import deepspeed_tpu_torch.telemetry as tt
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu.serving import Request as JRequest
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.inference.weights import llama_params_from_numpy
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.serving import Request, ServingEngine

VOCAB = 512


def _ttft_config(threshold_ms=100.0, objective=0.9, burn=2.0,
                 short_s=10.0, long_s=60.0, min_events=5, severity="page"):
    return {"slis": [{"name": "ttft", "kind": "latency",
                      "metric": "serving/ttft_ms",
                      "threshold_ms": threshold_ms, "objective": objective}],
            "rules": [{"sli": "ttft", "short_s": short_s, "long_s": long_s,
                       "burn": burn, "min_events": min_events,
                       "severity": severity}]}


def _timeline(slo):
    return [dataclasses.astuple(a) for a in slo.alerts]


# --------------------------------------------------------------- SLO engine
def _window_math(t):
    reg = t.MetricsRegistry()
    slo = t.SLOEngine(_ttft_config(), registry=reg, eval_interval_s=0.0)
    h = reg.histogram("serving/ttft_ms")
    for v in [10.0] * 90 + [500.0] * 10:
        h.observe(v)
    slo.evaluate(0.0)
    out = [slo._window(slo.slis["ttft"], 0.0, 60.0),
           slo.budget_consumed("ttft")]
    for _ in range(100):
        h.observe(10.0)
    slo.evaluate(30.0)
    out += [slo._window(slo.slis["ttft"], 30.0, 25.0),
            slo.budget_consumed("ttft")]
    return out


def _multiwindow(t):
    reg = t.MetricsRegistry()
    slo = t.SLOEngine(_ttft_config(burn=2.0, short_s=10.0, long_s=40.0,
                                   min_events=4),
                      registry=reg, eval_interval_s=0.0)
    h = reg.histogram("serving/ttft_ms")
    out = []
    for step in range(200):
        n, v = ((1, 1.0) if step < 40 else (6, 900.0) if step == 40
                else (1, 900.0) if step < 90 else (5, 1.0))
        for _ in range(n):
            h.observe(v)
        out.append((slo.evaluate(float(step)) != [], tuple(slo.firing())))
    return out, _timeline(slo)


def _min_events(t):
    reg = t.MetricsRegistry()
    slo = t.SLOEngine(_ttft_config(burn=2.0, min_events=50), registry=reg,
                      eval_interval_s=0.0)
    for _ in range(10):
        reg.histogram("serving/ttft_ms").observe(900.0)
    slo.evaluate(1.0)
    return slo.firing(), _timeline(slo)


def _availability(t):
    cfg = {"slis": [{"name": "avail", "kind": "availability",
                     "good": "serving/finished_requests",
                     "bad": ["serving/shed_deadline", "serving/cancelled"],
                     "objective": 0.9}],
           "rules": [{"sli": "avail", "short_s": 5.0, "long_s": 20.0,
                      "burn": 2.0, "min_events": 5}]}
    reg = t.MetricsRegistry()
    slo = t.SLOEngine(cfg, registry=reg, eval_interval_s=0.0)
    reg.counter("serving/finished_requests").inc(60)
    reg.counter("serving/shed_deadline").inc(30)
    reg.counter("serving/cancelled").inc(10)
    slo.evaluate(0.0)
    return (slo._window(slo.slis["avail"], 0.0, 20.0), slo.firing(),
            reg.snapshot()["counters"])


def _gauge_floor(t):
    cfg = {"slis": [{"name": "mfu", "kind": "gauge_floor",
                     "metric": "train/mfu", "floor": 0.4, "objective": 0.5}],
           "rules": [{"sli": "mfu", "short_s": 4.0, "long_s": 16.0,
                      "burn": 1.5, "min_events": 4}]}
    reg = t.MetricsRegistry()
    slo = t.SLOEngine(cfg, registry=reg, eval_interval_s=0.0)
    for step in range(40):
        reg.gauge("train/mfu").set(0.45 if step < 8 else 0.1)
        slo.evaluate(float(step))
    return slo.firing(), _timeline(slo), slo.budget_consumed("mfu")


def _replay_and_subscribers(t):
    reg = t.MetricsRegistry()
    slo = t.SLOEngine(_ttft_config(burn=1.5, short_s=5.0, long_s=20.0,
                                   min_events=3),
                      registry=reg, eval_interval_s=1.0)
    seen = []
    slo.add_alert_callback(lambda a: 1 / 0)      # a broken subscriber
    slo.add_alert_callback(lambda a: seen.append((a.rule, a.kind)))
    for step in range(60):
        reg.histogram("serving/ttft_ms").observe(
            1.0 if (step < 20 or step > 45) else 900.0)
        slo.maybe_evaluate(step * 0.5)
    slo.inject_alert(t.SLOAlert("x", "ttft", "warn", "fired", 99.0, 1.0,
                                1.0, 0.5))
    return (_timeline(slo), seen, slo.evaluations,
            reg.snapshot()["counters"])


@pytest.mark.parametrize("scenario", [_window_math, _multiwindow, _min_events,
                                      _availability, _gauge_floor,
                                      _replay_and_subscribers],
                         ids=lambda f: f.__name__.strip("_"))
def test_slo_engine_matches_jax(scenario):
    want, got = scenario(jt), scenario(tt)
    assert got == want


def test_slo_config_errors_match_jax():
    bad = {
        "slis": [
            {"name": "a", "kind": "latency", "metric": "m",
             "threshold_ms": 10, "objective": 0.99},
            {"name": "a", "kind": "nope", "objective": 2.0},
            {"kind": "latency"},
            {"name": "g", "kind": "gauge_floor", "objective": 0.5},
            {"name": "av", "kind": "availability", "objective": 0.5},
            {"name": "ok", "kind": "latency", "metric": "m2",
             "threshold_ms": 10, "objective": 0.99},
        ],
        "rules": [
            {"sli": "zzz", "short_s": 5, "long_s": 10, "burn": 1},
            {"sli": "ok", "short_s": 60, "long_s": 60, "burn": 1},
            {"sli": "ok", "short_s": 5, "long_s": 60, "burn": 500},
            {"sli": "ok", "short_s": -1, "long_s": 60, "burn": 0,
             "severity": "sms", "min_events": -3},
        ],
    }
    want = jt.validate_slo_config(bad)
    assert tt.validate_slo_config(bad) == want and len(want) >= 13
    for cfg in ({"slis": [], "rules": [{"sli": "x"}]}, "nope", {"slis": 1}):
        with pytest.raises(jt.SLOConfigError if isinstance(cfg, dict) and
                           "rules" in cfg else Exception) as w:
            jt.parse_slo_config(cfg)
        with pytest.raises(tt.SLOConfigError) as g:
            tt.parse_slo_config(cfg)
        assert str(g.value) == str(w.value)
    assert tt.DEFAULT_SLO_CONFIG == jt.DEFAULT_SLO_CONFIG
    assert tt.validate_slo_config(tt.DEFAULT_SLO_CONFIG) == []


# ----------------------------------------------------- tenants and recorder
def _ledger(t):
    reg = t.MetricsRegistry()
    out = []
    for led in (t.TenantLedger(None), t.TenantLedger(reg)):
        a = led.resolve("a")
        evil = led.resolve('evil/tenant with "quotes" and\nnewlines')
        for ten, n in ((a, 10), (evil, 7), (led.resolve(None), 3)):
            led.note_admitted(ten, n)
            led.note_prefill(ten, n - 2, saved=2)
            led.note_tokens(ten, 5)
            led.note_kv_occupancy(ten, 4, 0.25, 100.0)
            led.note_kv_occupancy(ten, 0, 0.25, 100.0)
            led.note_preemption(ten)
            led.note_shed(ten)
            led.note_ttft(ten, 5.0 * n)
            led.note_tpot(ten, 2.0)
        out.append(led.totals())
    return out, reg.to_prometheus()


def test_tenant_ledger_matches_jax():
    want, got = _ledger(jt), _ledger(tt)
    assert got == want
    totals, prometheus = got
    assert {"a", "default"} < set(totals[0]) and totals[0] == totals[1]
    evil = next(k for k in totals[0] if k.startswith("evil"))
    assert "/" not in evil and "dstpu_serving_tenant_evil" in prometheus


def _recorder(t, tmp):
    reg = t.MetricsRegistry()
    rec = t.FlightRecorder(dump_dir=str(tmp), max_spans=4, max_events=3,
                           registry=reg)
    sink = t.JsonlSink(str(tmp / "t.jsonl"))
    tee = rec.tee(sink)
    reg.attach_sink(tee)
    for i in range(10):
        tee.write({"kind": "span", "i": i})
    for rid in range(5):
        reg.event("serving/finished_requests", rid=rid)
    rec.note_alert({"kind": "slo_eval", "t": 1.0,
                    "rules": {"r:page:2x": {"firing": True}},
                    "budget_consumed": {"ttft": 0.5}})
    payload = rec.trigger("unit_incident", replica="r1")
    with open(payload["path"]) as f:
        loaded = json.load(f)
    name = os.path.basename(payload["path"])
    cool = t.FlightRecorder(dump_dir=None, registry=t.MetricsRegistry(),
                            trigger_cooldown=5)
    cool.observe({"kind": "event"})
    gates = [cool.trigger("crash") is not None, cool.trigger("crash") is None]
    for _ in range(5):
        cool.observe({"kind": "event"})
    gates += [cool.trigger("crash") is not None,
              cool.trigger("other") is not None]
    # a page alert dumps; every evaluation lands in the alert ring
    preg = t.MetricsRegistry()
    prec = t.FlightRecorder(dump_dir=str(tmp / "page"), registry=preg)
    slo = t.SLOEngine(_ttft_config(burn=1.0, min_events=1), registry=preg,
                      eval_interval_s=0.0, flight_recorder=prec)
    for _ in range(10):
        preg.histogram("serving/ttft_ms").observe(900.0)
    slo.evaluate(50.0)
    sink.close()
    n_spans = sum(r.get("kind") == "span"
                  for r in t.read_jsonl(str(tmp / "t.jsonl")))
    for snap in [loaded["metrics"]] + loaded["snapshots"]:
        snap.pop("t", None)
    return (loaded, name, rec.ring_evicted, gates,
            [(d["reason"], os.path.basename(d["path"])) for d in prec.dumps],
            [r["kind"] for r in prec.alerts], n_spans,
            reg.snapshot()["counters"])


def test_flight_recorder_matches_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _recorder(jt, tmp_path / "jax")
    got = _recorder(tt, tmp_path / "port")
    assert got == want
    loaded = got[0]
    assert got[1] == "flight_000_unit_incident.json"
    assert [s["i"] for s in loaded["spans"]] == [6, 7, 8, 9]
    assert loaded["complete"] is True and got[6] == 10


# ------------------------------------------------------------------ serving
class VirtualClock:
    def __init__(self, dt=0.001):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


@pytest.fixture(scope="module")
def engines():
    groups.reset()
    jeng = deepspeed_tpu.init_inference(JLlamaModel(JLlamaConfig.tiny()),
                                        dtype="fp32", max_out_tokens=128)
    params = llama_params_from_numpy(jax.device_get(jeng.params), "cpu",
                                     torch.float32)
    teng = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig.tiny()), dtype="fp32", device="cpu",
        params=params)
    return jeng, teng


SERVE_SLO = {
    "slis": [{"name": "ttft", "kind": "latency", "metric": "serving/ttft_ms",
              "threshold_ms": 20.0, "objective": 0.5},
             {"name": "avail", "kind": "availability",
              "good": "serving/finished_requests",
              "bad": ["serving/shed_deadline"], "objective": 0.9}],
    "rules": [{"sli": "ttft", "short_s": 0.05, "long_s": 0.2, "burn": 1.2,
               "min_events": 2, "severity": "page"},
              {"sli": "avail", "short_s": 0.05, "long_s": 0.2, "burn": 2.0,
               "min_events": 2, "severity": "warn"}],
}


def _trace():
    """(rid, prompt, max_new, arrival, priority, deadline, tenant): four
    class-1 prompts sharing a 40-token prefix arrive first and fill the
    slots; class-0 short prompts follow and preempt them; one class-1
    request is shed at its deadline."""
    rng = np.random.RandomState(5)
    prefix = rng.randint(0, VOCAB, size=40).tolist()
    out = []
    for i in range(10):
        pri = int(i >= 4)
        pri = 1 - pri
        prompt = (prefix + rng.randint(0, VOCAB, size=8 + i).tolist()
                  if pri else rng.randint(0, VOCAB, size=5 + i).tolist())
        out.append((i, prompt, 6 + i % 3, 0.0 if pri else 0.01 * i, pri,
                    0.001 if i == 3 else None,
                    "interactive" if pri == 0 else "batch"))
    return out


def _serve(eng, jax_side, prefix_cache, armed, tmp=None):
    pkg = jt if jax_side else tt
    cls = JServingEngine if jax_side else ServingEngine
    req = JRequest if jax_side else Request
    kw = dict(num_slots=2, max_len=128, buckets=(16, 64),
              prefill_token_budget=32, preemption="swap",
              prefix_cache=prefix_cache, time_fn=VirtualClock())
    if prefix_cache:
        kw.update(block_size=16, num_blocks=14)
    srv = None
    if armed:
        reg = pkg.MetricsRegistry()
        sink = None
        if tmp is not None:
            sink = pkg.JsonlSink(str(tmp))
            reg.attach_sink(sink)
        rec = pkg.FlightRecorder(registry=reg)
        slo = pkg.SLOEngine(SERVE_SLO, registry=reg, eval_interval_s=0.0,
                            flight_recorder=rec)
        srv = cls(eng, telemetry=reg, slo=slo, tenants=True,
                  tracer=pkg.SpanTracer(sink=sink), **kw)
    else:
        srv = cls(eng, telemetry=False, **kw)
    reqs = []
    for rid, prompt, new, arr, pri, dl, ten in _trace():
        reqs.append(req(rid=rid, prompt=prompt, max_new_tokens=new,
                        arrival_time=arr, priority=pri, deadline=dl,
                        tenant_id=ten))
    res = {r.rid: r for r in srv.run(reqs)}
    return srv, res


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["slot_paged", "block_paged"])
def test_armed_serving_matches_jax_and_bare(engines, prefix_cache, tmp_path):
    jeng, teng = engines
    jsrv, want = _serve(jeng, True, prefix_cache, armed=True)
    tsrv, got = _serve(teng, False, prefix_cache, armed=True,
                       tmp=tmp_path / "t.jsonl")
    _, bare = _serve(teng, False, prefix_cache, armed=False)
    tokens = {k: r.tokens for k, r in got.items()}
    assert tokens == {k: r.tokens for k, r in want.items()}
    assert tokens == {k: r.tokens for k, r in bare.items()}
    assert got[3].finish_reason == "shed_deadline"
    assert tsrv.preemptions == jsrv.preemptions >= 1
    # per-tenant totals, exactly the reference's; tokens conserved
    totals = tsrv.tenants.totals()
    assert totals == jsrv.tenants.totals()
    assert sum(t["decode_tokens"] for t in totals.values()) \
        == tsrv.tokens_generated
    assert sum(t["prefill_tokens_computed"] for t in totals.values()) \
        == tsrv.prefill_tokens_computed
    assert sum(t["sheds"] for t in totals.values()) == 1
    assert totals["batch"]["kv_block_seconds"] > 0
    # the alert timeline, exactly the reference's, and a page dump
    assert _timeline(tsrv.slo) == _timeline(jsrv.slo)
    assert any(a.kind == "fired" and a.severity == "page"
               for a in tsrv.slo.alerts)
    assert [d["reason"] for d in tsrv.slo.flight_recorder.dumps] == \
        [d["reason"] for d in jsrv.slo.flight_recorder.dumps]
    counters = tsrv.telemetry.snapshot()["counters"]
    jcounters = jsrv.telemetry.snapshot()["counters"]
    for name in ("serving/prefix_hit_tokens", "serving/prefix_miss_tokens",
                 "serving/blocks_cowed", "serving/blocks_evicted",
                 "slo/alert_fired", "slo/alert_resolved"):
        assert counters.get(name) == jcounters.get(name), name
    if prefix_cache:
        assert counters["serving/prefix_hit_tokens"] \
            == tsrv.prefix.hit_tokens == sum(
                t["prefill_tokens_saved"] for t in totals.values()) > 0
    # every program was timed or counted, under program_cache_sizes' names
    table = tsrv.record_attribution()
    assert set(table) == set(tsrv.program_cache_sizes())
    assert table["decode"]["calls"] == tsrv.decode_steps
    tsrv.telemetry.sink.close()
    _report_renders(tmp_path / "t.jsonl", tsrv)


def _report_renders(path, srv):
    """telemetry_report.py (imports nothing of either package) renders the
    port's stream: SLO, tenants, attribution; and a dump as a postmortem."""
    script = pathlib.Path(__file__).parents[1] / "scripts" / "telemetry_report.py"
    spec = importlib.util.spec_from_file_location("telemetry_report", script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    srv.telemetry.flush()
    records, bad = mod.load_records(str(path))
    assert bad == 0
    agg = mod.aggregate(records)
    assert agg["slo"] and agg["tenants"] and agg["attribution"]
    assert set(agg["tenants"]) == {"interactive", "batch"}
    dump = path.parent / "dump.json"
    srv.slo.flight_recorder.dump(str(dump), "unit")
    pm = mod.aggregate([], postmortem=mod.load_flight_dump(str(dump)))
    assert pm["postmortem"]["trigger"] == "unit"
    assert mod.render(agg) and mod.render(pm)
