"""Checkpointing in the port (deepspeed_tpu_torch/runtime/checkpoint_engine/,
utils/fs.py, the engine's save_checkpoint / load_checkpoint /
save_16bit_model, inference served from a tag) against the JAX package's,
on the CPU.

The port's counterparts of tests/unit/checkpoint/test_checkpoint.py,
test_fault_tolerance.py and test_async_checkpoint.py run on a port engine
training LLaMA ``tiny(max_seq_len=16)`` in fp32 (``device="cpu"``); faults
are injected by patching utils/fs.py's write and rename seams. The
cross-package tests share one JAX engine of the same model (built on one
device with the batch triple for world size 1, destroyed at teardown) and
one port engine.

Tolerances, and why:

* save, load and continue in the port: bit-identical losses, parameters
  and moments (the same f32 arithmetic on the same values);
* a tag crossing packages: parameters, moments and counters bit-identical
  (the same stored bytes); the next loss within 1e-6 relative (the same
  f32 parameters through two libraries' f32 forward: measured 7.7e-8
  and 0 on the two steps);
* the 16-bit files: the same uint16 bits (both round f32 to bf16 to
  nearest even); zero_to_fp32: the same f32 arrays;
* inference served from a tag: greedy tokens equal to those served from
  the engine's in-memory parameters (fp32, the same arithmetic).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu.parallel.topology import MeshTopology, ParallelDims
from deepspeed_tpu.runtime.checkpoint_engine import engine as jckpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.runtime.checkpoint_engine import engine as tckpt
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    AsyncCheckpointEngine,
    CheckpointCorruptionError,
    NativeCheckpointEngine,
    OrbaxCheckpointEngine,
    _flatten_state,
    _unflatten_into,
    verify_checkpoint,
)
from deepspeed_tpu_torch.utils import fs

SEQ, MICRO, GAS = 16, 2, 2
VOCAB = 512


def _cfg(**extra):
    cfg = {"train_batch_size": MICRO * GAS, "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-2, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
                                    "warmup_num_steps": 3}},
           "gradient_clipping": 1.0, "steps_per_print": 0, "seed": 5}
    cfg.update(extra)
    return cfg


def _batch(i):
    rng = np.random.RandomState(100 + i)
    start = rng.randint(0, VOCAB, size=(GAS, MICRO, 1))
    step = rng.randint(1, 7, size=(GAS, MICRO, 1))
    ids = ((start + step * np.arange(SEQ + 1)) % VOCAB).astype(np.int32)
    return {"input_ids": ids[..., :-1], "labels": ids[..., 1:]}


def _model():
    return LlamaModel(LlamaConfig.tiny(max_seq_len=SEQ),
                      compute_dtype=torch.float32)


def _engine(params=None, **extra):
    eng, *_ = deepspeed_tpu_torch.initialize(model=_model(), config=_cfg(**extra),
                                             device="cpu", params=params)
    return eng


def _train(eng, n, seed0=0):
    return [float(eng.train_batch_from_stacked(_batch(seed0 + i)))
            for i in range(n)]


def _state_np(eng):
    """Params, moments and scaler of a port engine as path-keyed numpy."""
    flat = {}
    for sec in ("params", "opt_state", "scaler"):
        for k, v in _flatten_state(getattr(eng.state, sec),
                                   prefix=f"{sec}::").items():
            flat[k] = (v.numpy().copy() if isinstance(v, torch.Tensor)
                       else np.asarray(v))
    return flat


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _truncate(path, keep=120):
    raw = open(path, "rb").read()
    assert len(raw) > keep
    open(path, "wb").write(raw[:keep])


# ------------------------------------------------------ save, load, resume
def test_save_load_continue_is_bit_identical(tmp_path):
    e1 = _engine()
    _train(e1, 3)
    e1.save_checkpoint(str(tmp_path), client_state={"note": 7})
    assert (tmp_path / "latest").read_text() == "global_step3"
    saved = _state_np(e1)
    after = _train(e1, 3, seed0=3)
    e2 = _engine()
    path, client = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step3") and client == {"note": 7}
    _assert_state_equal(saved, _state_np(e2))
    assert (e2.global_steps, e2.micro_steps, e2.state.global_step) == (3, 6, 3)
    assert e2.lr_scheduler.state_dict() == {"last_batch_iteration": 3}
    assert _train(e2, 3, seed0=3) == after
    _assert_state_equal(_state_np(e1), _state_np(e2))


class _Seqs:
    def __init__(self, n):
        rng = np.random.RandomState(3)
        start = rng.randint(0, VOCAB, size=(n, 1))
        ids = ((start + np.arange(SEQ + 1)) % VOCAB).astype(np.int32)
        self.items = [{"input_ids": r[:-1], "labels": r[1:]} for r in ids]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_resume_restores_the_dataloader_position(tmp_path):
    data = _Seqs(24)
    e1, *_ = deepspeed_tpu_torch.initialize(model=_model(), config=_cfg(),
                                            device="cpu", training_data=data)
    [e1.train_batch() for _ in range(2)]
    e1.save_checkpoint(str(tmp_path), tag="t")
    want_state = e1.training_dataloader.state_dict()
    meta = json.loads(str(np.load(tmp_path / "t" / "state.npz")["__meta__"]))
    assert meta["dataloader"] == want_state
    after = [float(e1.train_batch()) for _ in range(3)]
    e2, *_ = deepspeed_tpu_torch.initialize(model=_model(), config=_cfg(),
                                            device="cpu", training_data=data)
    e2.load_checkpoint(str(tmp_path), tag="t")
    assert e2.training_dataloader.state_dict() == want_state
    assert [float(e2.train_batch()) for _ in range(3)] == after


def test_load_module_only_and_optimizer_flags(tmp_path):
    e1 = _engine()
    _train(e1, 2)
    e1.save_checkpoint(str(tmp_path))
    e2 = _engine()
    fresh = _state_np(e2)
    e2.load_checkpoint(str(tmp_path), load_module_only=True)
    got, want = _state_np(e2), _state_np(e1)
    for k in got:
        ref = want if k.startswith("params::") else fresh
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_lr_scheduler_state_restored(tmp_path):
    e1 = _engine()
    _train(e1, 2)
    e1.save_checkpoint(str(tmp_path))
    e2 = _engine()
    e2.load_checkpoint(str(tmp_path))
    assert e2.lr_scheduler.state_dict() == e1.lr_scheduler.state_dict()
    assert e2.get_lr() == e1.get_lr()
    e3 = _engine()
    e3.load_checkpoint(str(tmp_path), load_lr_scheduler_states=False)
    assert e3.lr_scheduler.state_dict() != e1.lr_scheduler.state_dict()


def test_async_save_through_the_engine(tmp_path):
    e1 = _engine(checkpoint={"async_save": True})
    _train(e1, 2)
    e1.save_checkpoint(str(tmp_path))
    saved = _state_np(e1)
    _train(e1, 1, seed0=2)          # in-place updates race the write
    e1._checkpoint_engine().wait()
    e2 = _engine()
    e2.load_checkpoint(str(tmp_path))
    _assert_state_equal(saved, _state_np(e2))


def test_checkpoint_spans_and_events(tmp_path):
    from deepspeed_tpu_torch.telemetry import get_registry

    e = _engine(telemetry={"spans": True})
    reg = get_registry()
    before = [reg.counter(n).value for n in ("checkpoint/saves",
                                               "checkpoint/loads")]
    e.save_checkpoint(str(tmp_path))
    e.load_checkpoint(str(tmp_path))
    after = [reg.counter(n).value for n in ("checkpoint/saves",
                                              "checkpoint/loads")]
    assert after == [b + 1 for b in before]
    names = [s.name for s in e.tracer.spans_for(e._train_trace)]
    assert "checkpoint_save" in names and "checkpoint_load" in names
    e.destroy()


# ------------------------------------------------------ integrity, faults
def test_manifest_verifies_and_save_leaves_meta_alone(tmp_path):
    path = str(tmp_path / "state.npz")
    meta = {"global_step": 3}
    NativeCheckpointEngine().save(
        {"params": {"w": torch.arange(6.0), "h": torch.ones(2).half(),
                    "b": torch.ones(3).bfloat16()}, "__meta__": meta}, path)
    assert meta == {"global_step": 3}
    assert verify_checkpoint(path) == (True, "ok")
    out = NativeCheckpointEngine().load(path)
    assert out["params"]["b"].dtype == torch.bfloat16
    assert out["params"]["h"].dtype == torch.float16
    assert torch.equal(out["params"]["w"], torch.arange(6.0))


def _rewrite(path, mutate):
    data = np.load(path)
    arrays = {k: data[k] for k in data.files}
    mutate(arrays)
    np.savez(path, **arrays)


@pytest.mark.parametrize("fault", ["truncated", "missing_array",
                                   "modified_array", "no_manifest"])
def test_integrity_faults_are_detected(tmp_path, fault):
    path = str(tmp_path / "state.npz")
    NativeCheckpointEngine().save({"params": {"w": torch.arange(8.0),
                                              "v": torch.ones(3)}}, path)
    if fault == "truncated":
        _truncate(path)
    elif fault == "missing_array":
        _rewrite(path, lambda a: a.pop("params::v"))
    elif fault == "modified_array":
        _rewrite(path, lambda a: a.__setitem__("params::w", a["params::w"] + 1))
    else:
        _rewrite(path, lambda a: a.__setitem__("__meta__", np.asarray("{}")))
    ok, reason = verify_checkpoint(path)
    assert not ok, reason
    if fault == "no_manifest":
        assert verify_checkpoint(path, require_manifest=False)[0]
        NativeCheckpointEngine().load(path)      # legacy: loads, unverified
    else:
        with pytest.raises(CheckpointCorruptionError):
            NativeCheckpointEngine().load(path)


class _Crash(Exception):
    pass


def _two_tags(tmp_path):
    """t1 (kept as the good state), then t2, both from one engine."""
    ck = str(tmp_path / "ck")
    e1 = _engine()
    _train(e1, 1)
    e1.save_checkpoint(ck, tag="t1")
    good = _state_np(e1)
    _train(e1, 1, seed0=1)
    return ck, e1, good


def _resumed(ck):
    e2 = _engine()
    path, _ = e2.load_checkpoint(ck)
    return e2, path


@pytest.mark.parametrize("case", [
    "corrupt_latest", "silent_torn_write", "stale_latest", "garbage_latest",
    "two_corrupt_tags", "torn_client_state", "crash_mid_write",
    "crash_before_rename"])
def test_auto_resume_walks_back_to_the_newest_valid_tag(tmp_path, monkeypatch,
                                                        case):
    ck, e1, good = _two_tags(tmp_path)
    root = tmp_path / "ck"
    if case in ("crash_mid_write", "crash_before_rename", "silent_torn_write"):
        real_stream, real_replace = fs.stream_write, fs.replace

        def torn(path, writer):
            real_stream(path, writer)
            _truncate(path, 80)
            if case == "crash_mid_write":
                raise _Crash()

        def crash_replace(src, dst):
            raise _Crash()

        if case == "crash_before_rename":
            monkeypatch.setattr(fs, "replace", crash_replace)
        else:
            monkeypatch.setattr(fs, "stream_write", torn)
        tag = "t1" if case == "crash_before_rename" else "t2"
        if case == "silent_torn_write":
            e1.save_checkpoint(ck, tag=tag)       # "succeeds"
            assert (root / "latest").read_text() == "t2"
        else:
            with pytest.raises(_Crash):
                e1.save_checkpoint(ck, tag=tag)
            assert (root / "latest").read_text() == "t1"
        monkeypatch.setattr(fs, "stream_write", real_stream)
        monkeypatch.setattr(fs, "replace", real_replace)
    else:
        e1.save_checkpoint(ck, tag="t2")
        os.utime(root / "t1" / "state.npz", (1, 1))
        os.utime(root / "t2" / "state.npz", (2, 2))
        if case == "corrupt_latest":
            _truncate(root / "t2" / "state.npz")
            assert not tckpt.validate_checkpoint_tag(ck, "t2")[0]
        elif case == "stale_latest":
            (root / "latest").write_text("ghost_tag")
            _truncate(root / "t2" / "state.npz")
        elif case == "garbage_latest":
            (root / "latest").write_bytes(b"\xff\xfe\x00\x9c\x80garbage")
            _truncate(root / "t2" / "state.npz")
        elif case == "two_corrupt_tags":
            _train(e1, 1, seed0=2)
            e1.save_checkpoint(ck, tag="t3")
            os.utime(root / "t3" / "state.npz", (3, 3))
            _truncate(root / "t3" / "state.npz")
            _truncate(root / "t2" / "state.npz")
        else:
            (root / "t2" / "client_state.json").write_text('{"global_st')
    assert tckpt.validate_checkpoint_tag(ck, "t1")[0]
    e2, path = _resumed(ck)
    assert path.endswith("t1"), path
    _assert_state_equal(good, _state_np(e2))
    assert e2.global_steps == 1


def test_transient_write_errors_are_retried(tmp_path, monkeypatch):
    monkeypatch.setattr(fs, "DEFAULT_BASE_DELAY_S", 0.0)
    real = fs.stream_write
    fails = [2]

    def flaky(path, writer):
        if fails[0]:
            fails[0] -= 1
            raise OSError("transient")
        real(path, writer)

    monkeypatch.setattr(fs, "stream_write", flaky)
    e = _engine()
    _train(e, 1)
    e.save_checkpoint(str(tmp_path), tag="t1")
    assert fails[0] == 0 and tckpt.validate_checkpoint_tag(str(tmp_path), "t1")[0]
    assert (tmp_path / "latest").read_text() == "t1"


def test_newest_valid_tag_wins_over_a_stale_pointer(tmp_path):
    ck = str(tmp_path)
    e1 = _engine()
    _train(e1, 1)
    e1.save_checkpoint(ck, tag="older")
    _train(e1, 1, seed0=1)
    e1.save_checkpoint(ck, tag="newer")
    os.utime(tmp_path / "older" / "state.npz", (1, 1))
    os.utime(tmp_path / "newer" / "state.npz", (2, 2))
    (tmp_path / "latest").write_text("ghost")
    assert tckpt.list_checkpoint_tags(ck) == ["newer", "older"]
    e2, path = _resumed(ck)
    assert path.endswith("newer")
    _assert_state_equal(_state_np(e1), _state_np(e2))


@pytest.mark.parametrize("case", ["all_corrupt", "empty", "missing_tag"])
def test_load_failures_are_typed(tmp_path, case):
    ck = str(tmp_path / "ck")
    if case == "empty":
        assert _engine().load_checkpoint(ck) == (None, {})
        return
    e1 = _engine()
    _train(e1, 1)
    e1.save_checkpoint(ck, tag="t1")
    if case == "missing_tag":
        (tmp_path / "ck" / "latest").write_text("gone")
        with pytest.raises(FileNotFoundError) as ei:
            e1.load_checkpoint(ck, tag="gone")
        assert all(w in str(ei.value) for w in ("gone", "t1", "latest"))
        return
    _train(e1, 1, seed0=1)
    e1.save_checkpoint(ck, tag="t2")
    _truncate(tmp_path / "ck" / "t1" / "state.npz")
    _truncate(tmp_path / "ck" / "t2" / "state.npz")
    (tmp_path / "ck" / "latest").write_bytes(b"\xff\xfe\x00corrupt")
    with pytest.raises(CheckpointCorruptionError) as ei:
        _engine().load_checkpoint(ck)
    assert "no valid checkpoint" in str(ei.value)
    assert "t1" in str(ei.value) and "t2" in str(ei.value)


# ----------------------------------------------------------------- async
def test_async_snapshot_is_isolated_and_meta_deep_copied(tmp_path):
    eng = AsyncCheckpointEngine()
    w = torch.zeros(1000)
    meta = {"global_step": 1, "nested": {"k": 0}}
    path = str(tmp_path / "c" / "state.npz")
    eng.save({"params": {"w": w}, "__meta__": meta}, path)
    w += 999.0                       # training goes on at once
    meta["nested"]["k"] = 999
    eng.commit("tag")
    out = eng.load(path)
    assert torch.equal(out["params"]["w"], torch.zeros(1000))
    assert out["__meta__"]["nested"] == {"k": 0}


def test_async_errors_aggregate_and_block_latest(tmp_path, monkeypatch):
    eng = AsyncCheckpointEngine()
    eng._errors.extend([IOError("disk full"), IOError("quota exceeded")])
    with pytest.raises(RuntimeError) as ei:
        eng.wait()
    assert all(w in str(ei.value)
               for w in ("disk full", "quota exceeded", "2 errors"))
    e = _engine(checkpoint={"async_save": True})
    ck = e._checkpoint_engine()

    def boom(state, path, on_success=None):
        raise IOError("disk full")

    monkeypatch.setattr(ck.inner, "save", boom)
    e.save_checkpoint(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="disk full"):
        ck.wait()
    assert not (tmp_path / "ck" / "latest").exists()


def test_orbax_engine_is_refused():
    with pytest.raises(NotPortedError, match="Orbax"):
        OrbaxCheckpointEngine()


# ------------------------------------------------- across the two packages
@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX engine and a port engine of the same LLaMA, and the tags each
    wrote: JAX trains 2 steps and saves ``jax/t2``; the port loads it,
    trains step 3 and saves ``port/t3``; JAX then loads that."""
    root = tmp_path_factory.mktemp("cross")
    cfg = _cfg()
    jm = JLlamaModel(JLlamaConfig.tiny(max_seq_len=SEQ), compute_dtype=jnp.float32)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jm, config=JConfig(cfg, world_size=1),
        topology=MeshTopology(ParallelDims(), devices=jax.devices()[:1]))
    jl = [float(jax.device_get(jeng.train_batch_from_stacked(_batch(i))))
          for i in range(2)]
    jeng.save_checkpoint(str(root / "jax"), tag="t2")
    jsaved = jckpt_flat(jeng)
    teng = _engine()
    teng.load_checkpoint(str(root / "jax"))
    tloaded = _state_np(teng)
    l3 = (float(jax.device_get(jeng.train_batch_from_stacked(_batch(2)))),
          float(teng.train_batch_from_stacked(_batch(2))))
    teng.save_checkpoint(str(root / "port"), tag="t3")
    jeng.load_checkpoint(str(root / "port"))
    jloaded = jckpt_flat(jeng)
    counters = ((jeng.global_steps, jeng.micro_steps, jeng.skipped_steps,
                 int(jax.device_get(jeng.state.global_step))),
                (teng.global_steps, teng.micro_steps, teng.skipped_steps,
                 teng.state.global_step))
    l4 = (float(jax.device_get(jeng.train_batch_from_stacked(_batch(3)))),
          float(teng.train_batch_from_stacked(_batch(3))))
    out = dict(root=root, jeng=jeng, teng=teng, jsaved=jsaved, tloaded=tloaded,
               jloaded=jloaded, tsaved3=None, l3=l3, l4=l4, jl=jl,
               counters=counters)
    yield out
    jeng.destroy()
    teng.destroy()


def jckpt_flat(jeng):
    from deepspeed_tpu.runtime.checkpoint_engine.checkpoint_engine import (
        _flatten_state as jflat)

    flat = {}
    for sec in ("params", "opt_state", "scaler"):
        for k, v in jflat(getattr(jeng.state, sec), prefix=f"{sec}::").items():
            flat[k] = np.asarray(v)
    return flat


def _npz_layout(path):
    data = np.load(path)
    return {k: (str(data[k].dtype), data[k].shape) for k in data.files
            if k != "__meta__"}


def test_tags_have_the_reference_layout(pair):
    root = pair["root"]
    want = _npz_layout(root / "jax" / "t2" / "state.npz")
    assert _npz_layout(root / "port" / "t3" / "state.npz") == want
    assert {k.split("::")[0] for k in want} == {"params", "opt_state", "scaler"}
    jcs = json.loads((root / "jax" / "t2" / "client_state.json").read_text())
    tcs = json.loads((root / "port" / "t3" / "client_state.json").read_text())
    assert tcs.keys() == jcs.keys()
    for k in ("zero_stage", "dtype", "client_state", "mesh_shape"):
        assert tcs[k] == jcs[k], k
    assert tcs["lr_scheduler"] == {"last_batch_iteration": 3}
    assert jcs["lr_scheduler"] == {"last_batch_iteration": 2}


def test_a_reference_tag_loads_into_the_port(pair):
    tl = {k: v.astype(pair["jsaved"][k].dtype) for k, v in pair["tloaded"].items()}
    _assert_state_equal(pair["jsaved"], tl)
    jl3, tl3 = pair["l3"]
    assert abs(tl3 - jl3) <= 1e-6 * abs(jl3)


def test_a_port_tag_loads_into_the_reference(pair):
    flat = _state_np(pair["teng"])     # the port after step 4
    jl = pair["jloaded"]               # the reference right after loading t3
    data = np.load(pair["root"] / "port" / "t3" / "state.npz")
    for k, v in jl.items():
        np.testing.assert_array_equal(v, data[k], err_msg=k)
    assert flat.keys() == jl.keys()
    (jc, tc) = pair["counters"]
    assert jc == tc == (3, 6, 0, 3)
    jl4, tl4 = pair["l4"]
    assert abs(tl4 - jl4) <= 1e-6 * abs(jl4)


def test_keys_and_unflatten_match_the_reference(pair):
    teng = pair["teng"]
    keys = set(_flatten_state(teng.state.opt_state)) | {
        "scaler/" + k for k in _flatten_state(teng.state.scaler)}
    assert {"step", "exp_avg/embed", "exp_avg_sq/blocks/wq",
            "scaler/cur_scale", "scaler/last_overflow_iter"} <= keys
    tree, missing = _unflatten_into({"a": torch.zeros(2), "b": [1, 2.0]},
                                    {"a": np.ones(2, np.float32),
                                     "b/0": np.int32(5)}, strict=False)
    assert missing == ["b/1"] and tree["b"] == [5, 2.0]
    assert torch.equal(tree["a"], torch.ones(2))
    with pytest.raises(KeyError):
        _unflatten_into({"a": torch.zeros(2)}, {})


def test_16bit_model_and_zero_to_fp32_match_the_reference(pair, tmp_path):
    jeng, root = pair["jeng"], pair["root"]
    teng = _engine()
    teng.load_checkpoint(str(root / "port"))      # the state jeng loaded
    jeng.load_checkpoint(str(root / "port"))
    jp = jckpt.save_16bit_model(jeng, str(tmp_path / "j"))
    tp = teng.save_16bit_model(str(tmp_path / "t"))
    jd, td = np.load(jp), np.load(tp)
    assert sorted(jd.files) == sorted(td.files)
    for k in jd.files:
        np.testing.assert_array_equal(jd[k], td[k], err_msg=k)
    for k, v in tckpt.load_16bit_model(jp).items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(v.view(torch.int16).numpy().view(np.uint16),
                                      jd[k + "@bf16"])
    jz = jckpt.zero_to_fp32(str(root / "port"), str(tmp_path / "j32.npz"))
    tz = tckpt.zero_to_fp32(str(root / "port"), str(tmp_path / "t32.npz"))
    jd, td = np.load(jz), np.load(tz)
    assert sorted(jd.files) == sorted(td.files)
    for k in jd.files:
        np.testing.assert_array_equal(jd[k], td[k], err_msg=k)


def test_inference_serves_a_tag(pair, tmp_path):
    root, teng = pair["root"], pair["teng"]
    ids = torch.tensor([[1, 5, 9, 2]])
    got = []
    for cfg in ({"checkpoint": str(root / "port")},
                {"checkpoint": {"checkpoint_dir": str(root / "port")}}):
        eng = deepspeed_tpu_torch.init_inference(
            LlamaModel(LlamaConfig.tiny(max_seq_len=SEQ)), device="cpu",
            config={"dtype": "fp32", **cfg})
        got.append(eng.generate(ids, max_new_tokens=6))
    loaded = _engine()
    loaded.load_checkpoint(str(root / "port"))
    mem = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig.tiny(max_seq_len=SEQ)), device="cpu",
        config={"dtype": "fp32"}, params=loaded.state.params)
    want = mem.generate(ids, max_new_tokens=6)
    for g in got:
        assert torch.equal(g, want)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        deepspeed_tpu_torch.init_inference(
            LlamaModel(LlamaConfig.tiny(max_seq_len=SEQ)), device="cpu",
            config={"checkpoint": {"nope": 1}})

