"""The port's telemetry core (deepspeed_tpu_torch/telemetry, utils/timer.py,
utils/nvtx.py) held against the JAX package's, on the CPU.

* Counters, gauges and histograms fed the same seeded observations give
  the reference ``MetricsRegistry``'s snapshot (p50/p95/p99 included) and
  Prometheus text, on default and custom buckets.
* A JSONL file written by the port reads back through the reference's
  ``read_jsonl`` and the other way round, torn last lines skipped and
  counted on both sides.
* On one seeded trace under a virtual clock, slot-paged and block-paged,
  the port's serving counters and gauges equal the reference engine's:
  finished requests, prefills, deadline sheds, the histograms' counts,
  peak queue depth, compiled programs, jit cache entries and recompiles.
* ``telemetry=False`` records nothing; ``telemetry=True`` records into the
  global registry.
* The config section, the MFU peak table, the timers on the host clock and
  ``trace()`` on the CPU.
"""

import json

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving import poisson_trace as jax_poisson_trace
from deepspeed_tpu.telemetry import MetricsRegistry as JMetricsRegistry
from deepspeed_tpu.telemetry import JsonlSink as JJsonlSink
from deepspeed_tpu.telemetry import read_jsonl as jax_read_jsonl
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.inference.weights import llama_params_from_numpy
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.serving import ServingEngine, poisson_trace
from deepspeed_tpu_torch.telemetry import (JsonlSink, MetricsRegistry,
                                           get_registry, get_telemetry_config,
                                           mfu, peak_flops_per_sec,
                                           read_jsonl, record_event,
                                           reset_registry, trace)
from deepspeed_tpu_torch.utils.nvtx import instrument_w_nvtx
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer)

SLOTS, MAX_LEN, BUCKETS, BS = 4, 128, (16, 64), 16


class VirtualClock:
    def __init__(self, dt=0.001):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _feed(reg, seed):
    rng = np.random.RandomState(seed)
    for v in rng.lognormal(1.0, 1.5, size=2000):
        reg.histogram("lat_ms").observe(float(v))
    for v in rng.uniform(0, 10, size=300):
        reg.histogram("small", buckets=(0.5, 1, 2, 4, 8)).observe(float(v))
    for n in rng.randint(1, 5, size=50):
        reg.counter("serving/prefills").inc(int(n))
    reg.gauge("serving/recompiles").set(0)
    reg.gauge("tokens_per_sec").set(float(rng.uniform()))
    reg.gauge("never_set")


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_matches_reference(seed):
    ours, ref = MetricsRegistry(), JMetricsRegistry()
    _feed(ours, seed)
    _feed(ref, seed)
    assert ours.snapshot() == ref.snapshot()
    for p in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
        assert (ours.histogram("lat_ms").percentile(p)
                == ref.histogram("lat_ms").percentile(p))
    assert ours.to_prometheus() == ref.to_prometheus()
    assert MetricsRegistry().histogram("empty").snapshot() == {"count": 0}


def _write(sink_cls, path):
    sink = sink_cls(str(path), flush_every=3)
    reg = MetricsRegistry()
    _feed(reg, 2)
    for step in range(5):
        sink.scalar("loss", 1.0 / (step + 1), step)
    sink.write({"kind": "event", "name": "save", "tag": "ckpt"})
    sink.write({"kind": "snapshot", "step": 5, "metrics": reg.snapshot()})
    sink.close()
    with open(path, "ab") as f:
        f.write(b'{"kind": "scalar", "tag": "lo')          # torn last line
    return sink


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_jsonl_round_trip_between_port_and_reference(tmp_path, writer):
    path = tmp_path / "telemetry.jsonl"
    sink = _write(JsonlSink if writer == "port" else JJsonlSink, path)
    assert sink.records_written == 7 and sink.records_dropped == 0
    ours, bad = read_jsonl(str(path), return_bad=True)
    theirs, jbad = jax_read_jsonl(str(path), return_bad=True)
    assert bad == jbad == 1
    assert ours == theirs and len(ours) == 7
    assert [r["kind"] for r in ours] == ["scalar"] * 5 + ["event", "snapshot"]
    assert ours[-1]["metrics"]["histograms"]["lat_ms"]["count"] == 2000


def test_registry_event_streams_to_the_sink(tmp_path):
    path = tmp_path / "events.jsonl"
    reg = MetricsRegistry(sink=JsonlSink(str(path)))
    reg.event("checkpoint/saved", step=3)
    reg.flush(step=3)
    reg.sink.close()
    recs = read_jsonl(str(path))
    assert recs[0]["name"] == "checkpoint/saved" and recs[0]["step"] == 3
    assert recs[1]["kind"] == "snapshot"
    assert recs[1]["metrics"]["counters"] == {"checkpoint/saved": 1}


@pytest.fixture(scope="module")
def engines():
    groups.reset()
    jeng = deepspeed_tpu.init_inference(JLlamaModel(JLlamaConfig.tiny()),
                                        dtype="fp32", max_out_tokens=MAX_LEN)
    params = llama_params_from_numpy(jax.device_get(jeng.params), "cpu",
                                     torch.float32)
    teng = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig.tiny()), dtype="fp32", device="cpu",
        params=params)
    return jeng, teng


def _trace(mod):
    kw = dict(rate=400.0, prompt_lens=[3, 11, 20, 40],
              max_new_choices=[2, 6, 9], vocab_size=512)
    reqs = (poisson_trace if mod == "port" else jax_poisson_trace)(
        np.random.RandomState(4), 9, **kw)
    for i, r in enumerate(reqs):
        r.priority = i % 2
    reqs[2].deadline = -1.0            # shed at admission
    return reqs


COUNTERS = ("serving/finished_requests", "serving/prefills",
            "serving/shed_deadline")
GAUGES = ("serving/compiled_programs", "serving/jit_cache_entries",
          "serving/recompiles", "serving/peak_queue_depth",
          "serving/mean_batch_fill_ratio", "serving/kv_pool_bytes",
          "serving/prefix_hit_rate", "serving/prefix_cached_blocks")
HISTOGRAMS = ("serving/latency_ms", "serving/queue_wait_ms",
              "serving/ttft_ms", "serving/tpot_ms", "serving/ttft_ms/p0",
              "serving/ttft_ms/p1", "serving/tpot_ms/p0")


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["slot_paged", "block_paged"])
def test_serving_telemetry_matches_reference(engines, prefix_cache):
    jeng, teng = engines
    kw = dict(num_slots=SLOTS, max_len=MAX_LEN, buckets=BUCKETS)
    if prefix_cache:
        kw.update(prefix_cache=True, block_size=BS)
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    jsrv = JServingEngine(jeng, telemetry=jreg, time_fn=VirtualClock(), **kw)
    tsrv = ServingEngine(teng, telemetry=treg, time_fn=VirtualClock(), **kw)
    jout = {r.rid: (r.tokens, r.finish_reason) for r in jsrv.run(_trace("jax"))}
    tout = {r.rid: (r.tokens, r.finish_reason) for r in tsrv.run(_trace("port"))}
    assert tout == jout
    assert jout[2][1] == "shed_deadline"
    want, got = jreg.snapshot(), treg.snapshot()
    for name in COUNTERS:
        assert got["counters"][name] == want["counters"][name], name
    for name in GAUGES:
        assert got["gauges"].get(name) == want["gauges"].get(name), name
    for name in HISTOGRAMS:
        assert got["histograms"][name]["count"] == \
            want["histograms"][name]["count"], name
    assert got["counters"]["serving/finished_requests"] == 8
    assert got["gauges"]["serving/recompiles"] == 0
    assert got["gauges"]["serving/compiled_programs"] == tsrv.program_count


def test_telemetry_off_records_nothing(engines):
    _, teng = engines
    reset_registry()
    srv = ServingEngine(teng, num_slots=SLOTS, max_len=MAX_LEN,
                        buckets=BUCKETS, time_fn=VirtualClock(),
                        telemetry=False)
    srv.run(_trace("port"))
    assert srv.telemetry is None
    assert get_registry().snapshot() == {"counters": {}, "gauges": {},
                                         "histograms": {}}
    srv = ServingEngine(teng, num_slots=SLOTS, max_len=MAX_LEN,
                        buckets=BUCKETS, time_fn=VirtualClock())
    srv.run(_trace("port"))
    assert srv.telemetry is get_registry()
    assert get_registry().snapshot()["counters"]["serving/prefills"] == 8
    reset_registry()


def test_config_mfu_timers_trace(tmp_path):
    cfg = get_telemetry_config({"telemetry": {"jsonl_path": "t.jsonl"}})
    assert cfg.enabled and cfg.jsonl_path == "t.jsonl" and cfg.sync_interval == 50
    # the span tracer and the flight recorder are ported
    cfg = get_telemetry_config({"telemetry": {"spans": True,
                                              "flight_recorder": True}})
    assert cfg.spans and cfg.flight_recorder and cfg.cost_analysis
    assert peak_flops_per_sec(1, "NVIDIA H100 80GB HBM3") == 989e12
    assert peak_flops_per_sec(1, "some other card") is None
    assert mfu(989e12, 2.0, 1, "NVIDIA H100 80GB HBM3") == 0.5
    assert mfu(0.0, 1.0, 1, "NVIDIA H100 80GB HBM3") is None
    timers = SynchronizedWallClockTimer(device="cpu")
    timers("fwd").start()
    timers("fwd").stop(record=True)
    assert timers.has("fwd") and timers("fwd").elapsed(reset=False) >= 0.0
    assert set(timers.get_mean(["fwd"])) == {"fwd"}
    tput = ThroughputTimer(batch_size=4, start_step=1, steps_per_output=2,
                           device="cpu", logging_fn=lambda msg: None)
    for _ in range(4):
        tput.start()
        tput.stop(global_step=True)
    assert tput.global_step_count == 4 and tput.avg_samples_per_sec() > 0

    @instrument_w_nvtx
    def step(x):
        return x * 2

    with trace(str(tmp_path / "trace")) as out:
        assert torch.equal(step(torch.ones(3)), torch.full((3,), 2.0))
    with open(f"{out}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("step" in e.get("name", "") for e in events)
    record_event("telemetry/test_event")
    assert get_registry().counter("telemetry/test_event").value >= 1
    reset_registry()
