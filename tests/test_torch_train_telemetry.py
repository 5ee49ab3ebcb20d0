"""Training telemetry of the port (runtime/engine.py: the step counters, the
periodic fence's gauges, the step-window spans, the flight recorder's tee,
the wall-clock breakdown, ``set_slo``) held against the JAX package's
engine on the CPU.

Both engines train the tiny GPT-2 in fp32 from the same weights (the JAX
engine's, carried over by the weight bridge), with ``telemetry`` on
(``sync_interval`` 2, a JSONL sink each) and ``cost_analysis`` off, so
both count the reference's fallback FLOPs, ``6 * N * tokens``. The
port-only tests start from the port's own seeded init (the engine copies
the parameters it is given).

* ``train/steps`` and ``train/tokens`` equal the reference's exactly, as
  do the counted FLOPs of a step; ``train/loss`` and ``train/grad_norm``,
  read at the fence after step 4, within 1e-4 relative (fp32 on the CPU:
  the two packages' losses agree to 1e-5, test_torch_training.py).
* An armed engine (spans, flight recorder, wall-clock breakdown) gives the
  bare engine's losses bit for bit; spans are recorded per fence-to-fence
  window; the wall-clock timers read every part of the step.
* Telemetry disabled records nothing and writes no file; ``set_slo``
  raises as the reference's does without the resilience sentinel; the
  forward/backward/step path counts its steps and tokens.
"""

import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.parallel.topology import MeshTopology, ParallelDims
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.telemetry import get_registry as jget_registry
from deepspeed_tpu.telemetry import reset_registry as jreset_registry
from deepspeed_tpu_torch.inference.weights import gpt2_params_from_numpy
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.telemetry import (get_registry, read_jsonl,
                                           reset_registry)
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER,
                                             FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER,
                                             TRAIN_BATCH_TIMER)

VOCAB, T, MICRO, GAS = 512, 32, 4, 2


def _config(telemetry=None, **extra):
    cfg = {"train_batch_size": MICRO * GAS, "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "steps_per_print": 0, "seed": 11}
    if telemetry is not None:
        cfg["telemetry"] = telemetry
    cfg.update(extra)
    return cfg


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start = rng.randint(0, VOCAB, size=(GAS, MICRO, 1))
        step = rng.randint(1, 7, size=(GAS, MICRO, 1))
        ids = ((start + step * np.arange(T + 1)) % VOCAB).astype(np.int32)
        out.append({"input_ids": ids[..., :-1], "labels": ids[..., 1:]})
    return out


def _jax_engine(cfg):
    model = JGPT2Model(JGPT2Config.tiny(max_seq_len=64), attn_impl="flash",
                       compute_dtype=jax.numpy.float32)
    engine, *_ = deepspeed_tpu.initialize(
        model=model, config=JConfig(cfg, world_size=1),
        topology=MeshTopology(ParallelDims(), devices=jax.devices()[:1]))
    return engine


def _port_engine(cfg, params):
    model = GPT2Model(GPT2Config.tiny(max_seq_len=64), attn_impl="flash",
                      compute_dtype=torch.float32)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                device="cpu", params=params)
    return engine


TELE = {"sync_interval": 2, "cost_analysis": False}


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    jreset_registry()
    path = tmp_path_factory.mktemp("jax") / "j.jsonl"
    engine = _jax_engine(_config(dict(TELE, jsonl_path=str(path))))
    yield engine
    # the engine's sink sits on the reference's global registry, which a
    # reset keeps: detach it, or a later engine in this process skips its own
    engine.destroy()
    assert jget_registry().sink is None


@pytest.fixture(scope="module")
def params0():
    model = GPT2Model(GPT2Config.tiny(max_seq_len=64),
                      compute_dtype=torch.float32)
    return model.init(torch.Generator().manual_seed(3), device="cpu",
                      dtype=torch.float32)


def test_step_counters_and_fence_gauges_match_jax(tmp_path, jax_engine):
    jeng = jax_engine
    jreset_registry()
    reset_registry()
    teng = _port_engine(_config(dict(TELE, jsonl_path=str(tmp_path / "t.jsonl"))),
                        gpt2_params_from_numpy(jax.device_get(jeng.state.params),
                                               "cpu"))
    for batch in _batches(4):
        jeng.train_batch_from_stacked(batch)
        teng.train_batch_from_stacked(batch)
    want, got = jget_registry().snapshot(), get_registry().snapshot()
    for name in ("train/steps", "train/tokens"):
        assert got["counters"][name] == want["counters"][name]
    assert got["counters"]["train/steps"] == 4
    assert got["counters"]["train/tokens"] == 4 * GAS * MICRO * T
    for name in ("train/loss", "train/grad_norm"):
        w, g = want["gauges"][name], got["gauges"][name]
        assert abs(g - w) <= 1e-4 * abs(w), (name, g, w)
    assert got["histograms"]["train/step_wall_ms"]["count"] == 4
    # fences at steps 1, 2 and 4 set the device-rate gauges from step 2 on
    for name in ("train/device_step_time_ms", "train/tokens_per_sec"):
        assert got["gauges"][name] > 0
    assert teng._telemetry_flops == jeng._telemetry_flops > 0
    # no peak on the CPU: no MFU, on either side
    assert "train/mfu" not in got["gauges"] and "train/mfu" not in want["gauges"]
    teng.destroy()
    assert get_registry().sink is None
    recs = read_jsonl(str(tmp_path / "t.jsonl"))
    assert [r["step"] for r in recs if r["kind"] == "snapshot"] == [1, 2, 4, 4]
    row = teng.train_step_attribution()["train_step"]
    assert row["flops"] == teng._telemetry_flops and row["calls"] == 4
    reset_registry()
    jreset_registry()


def test_armed_losses_equal_bare_and_spans_and_timers(tmp_path, params0):
    bare = _port_engine(_config({"enabled": False}),
                        params0)
    reset_registry()
    armed = _port_engine(
        _config({"sync_interval": 2, "spans": True, "flight_recorder": True,
                 "flight_dir": str(tmp_path / "flight"),
                 "jsonl_path": str(tmp_path / "t.jsonl")},
                wall_clock_breakdown=True, steps_per_print=2),
        params0)
    for batch in _batches(5, seed=1):
        lb = bare.train_batch_from_stacked(batch)
        la = armed.train_batch_from_stacked(batch)
        assert torch.equal(la, lb)
    # fences at steps 1, 2 and 4: two fence-to-fence windows
    spans = armed.tracer.spans_for(armed._train_trace)
    assert [(s.name, s.attrs["end_step"], s.attrs["steps"]) for s in spans] \
        == [("step_window", 2, 1), ("step_window", 4, 2)]
    assert all(s.attrs["tokens"] == s.attrs["steps"] * GAS * MICRO * T
               for s in spans)
    # the recorder's tee saw the spans and the fence snapshots
    rec = armed.flight_recorder
    assert len(rec.spans) == 2 and len(rec.snapshots) == 3
    payload = rec.trigger("unit")
    assert os.path.exists(payload["path"]) and payload["complete"]
    # logged (read, then reset) at steps 2 and 4; step 5's intervals are
    # read when asked for
    for name in (TRAIN_BATCH_TIMER, FORWARD_GLOBAL_TIMER,
                 BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER):
        per_step = 1 if name in (TRAIN_BATCH_TIMER, STEP_GLOBAL_TIMER) else GAS
        assert len(armed.timers(name)._record) == 4 * per_step
        assert armed.timers(name).elapsed(reset=False) > 0
        assert len(armed.timers(name)._record) == 5 * per_step
    armed.destroy()
    recs = read_jsonl(str(tmp_path / "t.jsonl"))
    assert sum(r["kind"] == "span" for r in recs) == 2
    reset_registry()


def test_disabled_telemetry_writes_nothing(tmp_path, params0):
    reset_registry()
    path = tmp_path / "t.jsonl"
    eng = _port_engine(_config({"enabled": False, "jsonl_path": str(path)}),
                       params0)
    for batch in _batches(2):
        eng.train_batch_from_stacked(batch)
    assert eng.telemetry is None and eng.timers is None
    assert get_registry().snapshot() == {"counters": {}, "gauges": {},
                                         "histograms": {}}
    assert not path.exists()
    assert eng.train_step_attribution() == {}


def test_set_slo_raises_without_the_sentinel_as_jax(jax_engine, params0):
    jeng = jax_engine
    teng = _port_engine(_config({"enabled": False}),
                        params0)
    with pytest.raises(ValueError) as want:
        jeng.set_slo(object())
    with pytest.raises(ValueError) as got:
        teng.set_slo(object())
    assert str(got.value) == str(want.value)
    teng.set_slo(None)
    assert teng.slo is None


def test_forward_backward_step_path_counts_steps(params0):
    reset_registry()
    eng = _port_engine(_config({"sync_interval": 1}, wall_clock_breakdown=True),
                       params0)
    for batch in _batches(2):
        for i in range(GAS):
            mb = {k: v[i] for k, v in batch.items()}
            loss = eng.forward(mb)
            eng.backward(loss)
            eng.step()
    snap = get_registry().snapshot()
    assert snap["counters"]["train/steps"] == 2
    assert snap["counters"]["train/tokens"] == 2 * GAS * MICRO * T
    assert snap["gauges"]["train/loss"] == pytest.approx(float(loss))
    assert len(eng.timers(STEP_GLOBAL_TIMER)._record) == 0   # not read yet
    assert eng.timers(STEP_GLOBAL_TIMER).mean() > 0
    assert len(eng.timers(STEP_GLOBAL_TIMER)._record) == 2
    # work between fences that is not training drops the rate's baseline:
    # the next fence sets no device rate
    rate = snap["gauges"]["train/device_step_time_ms"]
    eng._reset_telemetry_window()
    eng.train_batch_from_stacked(_batches(1, seed=3)[0])
    snap = get_registry().snapshot()
    assert snap["counters"]["train/steps"] == 3
    assert snap["gauges"]["train/device_step_time_ms"] == rate
    reset_registry()
