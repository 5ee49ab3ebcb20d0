"""Parity of the port's training path (deepspeed_tpu_torch/runtime/,
ops/adam.py, ``initialize``) with the JAX package's, on the CPU.

The JAX engine is built on one device with the batch triple solved for
world size 1, as the port's (no collective runs):

    deepspeed_tpu.initialize(model=m, config=DeepSpeedConfig(cfg, world_size=1),
                             topology=MeshTopology(ParallelDims(),
                                                   devices=jax.devices()[:1]))

and the port's engine starts from the JAX engine's initial parameters
(``params=gpt2_params_from_numpy(...)``, ``device="cpu"``). Both then
train GPT-2 ``tiny(max_seq_len=64)`` with ``attn_impl="flash"`` (the JAX
Pallas kernels in interpret mode, the port's plain versions) on the same
arithmetic-sequence batches.

Tolerances, and why:

* config, LR schedules, the loss scaler, the dataloader: exact (the same
  host arithmetic);
* optimizers, 5 steps on random trees: rtol 1e-5, atol 1e-7 (the same f32
  formulas; the two libraries round fused multiply-adds differently);
* the fp32 engine (``compute_dtype=float32``): loss and grad norm per step
  within 1e-5 relative. Parameters: Adam's first update is nearly
  ``sign(g)``, so an element whose gradient is near zero may move by +-lr
  in one package and -+lr in the other. Every element stays within
  2 x lr x steps, and at most 0.2% of elements differ by more than 1e-5
  (measured: losses equal, grad norms within 1.1e-7, parameters within
  2.1e-6 with no element over 1e-5);
* the bf16 engine (the model's bf16 default): loss within 1e-3 and grad
  norm within 5e-3 relative per step (bf16 rounding at slightly different
  points in the two libraries, compounded over four steps; measured 1.8e-5
  and 7.2e-4);
* the fp16 engine with a 2^32 initial loss scale: both overflow on both
  steps, skip both updates, halve the scale each time and count the same
  ``global_steps`` and applied steps.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.ops.adam as jadam
import deepspeed_tpu.runtime.dataloader as jdl
import deepspeed_tpu.runtime.lr_schedules as jlr
import deepspeed_tpu.runtime.precision as jprec
import deepspeed_tpu_torch
import deepspeed_tpu_torch.ops.adam as tadam
import deepspeed_tpu_torch.runtime.dataloader as tdl
import deepspeed_tpu_torch.runtime.lr_schedules as tlr
import deepspeed_tpu_torch.runtime.precision as tprec
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.parallel.topology import MeshTopology, ParallelDims
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch.accelerator import DeviceUnavailableError
from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.inference.weights import (gpt2_params_from_numpy,
                                                   numpy_from_params)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.utils.tree import tree_leaves

VOCAB, T, MICRO, GAS = 512, 32, 4, 2


# ----------------------------------------------------------------- config
BATCH_CASES = [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": 2},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 2},
    {"train_batch_size": 32, "gradient_accumulation_steps": 2},
    {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2},
    {"train_batch_size": 16},
    {"train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 33, "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": 2},
    {},
    {"train_batch_size": 8, "tensor_parallel": {"tp_size": 2}},
]


def _triple(cls, cfg, world):
    try:
        c = cls(cfg, world_size=world)
    except (AssertionError, Exception) as e:   # both packages must refuse
        return type(e).__name__
    return (c.train_batch_size, c.train_micro_batch_size_per_gpu,
            c.gradient_accumulation_steps, c.data_parallel_size)


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("case", range(len(BATCH_CASES)))
def test_batch_triple_matches_jax(case, world):
    cfg = BATCH_CASES[case]
    want, got = _triple(JConfig, cfg, world), _triple(TConfig, cfg, world)
    if isinstance(want, str):
        assert isinstance(got, str), got
    else:
        assert got == want


def test_config_sections_match_jax():
    cfg = {"train_batch_size": 8, "fp16": {"enabled": True, "hysteresis": 3},
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-4}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 7}},
           "gradient_clipping": 0.5, "data_types": {"grad_accum_dtype": "bf16"},
           "zero_optimization": {"stage": 0, "stage3_max_live_parameters": 5},
           "seed": 7}
    j, t = JConfig(cfg, world_size=1), TConfig(cfg, world_size=1)
    for name in ("fp16_enabled", "bfloat16_enabled", "optimizer_name",
                 "optimizer_params", "scheduler_name", "scheduler_params",
                 "gradient_clipping", "grad_accum_dtype", "seed",
                 "zero_optimization_stage", "steps_per_print"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.fp16_config.hysteresis == j.fp16_config.hysteresis == 3
    assert t.zero_config.max_live_parameters == j.zero_config.max_live_parameters == 5
    with pytest.raises(Exception):
        TConfig({"train_batch_size": 8, "fp16": {"enabled": True},
                 "bf16": {"enabled": True}})
    with pytest.raises(Exception):
        TConfig({"train_batch_size": 8, "data_types": {"grad_accum_dtype": "fp8"}})


# ------------------------------------------------------------ LR schedules
SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 10}),
    ("WarmupLR", {"warmup_max_lr": 2e-3, "warmup_num_steps": 7,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 30, "warmup_num_steps": 5}),
    ("WarmupCosineLR", {"total_num_steps": 30, "warmup_num_steps": 4,
                        "cos_min_ratio": 0.1}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 6, "decay_lr_rate": 0.1}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 4,
                     "lr_range_test_staircase": True}),
]


@pytest.mark.parametrize("name,params", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_lr_schedule_sequence_equals_jax(name, params):
    j = jlr.build_lr_scheduler(name, params)
    t = tlr.build_lr_scheduler(name, params)
    jseq, tseq = [], []
    for _ in range(40):
        jseq.append(j.step())
        tseq.append(t.step())
    assert tseq == jseq
    assert t.state_dict() == j.state_dict()


# ----------------------------------------------------------------- optimizers
OPTIMIZERS = [
    ("adamw", {"lr": 1e-2, "weight_decay": 0.01}),
    ("Adam", {"lr": 1e-2, "weight_decay": 0.1, "adam_w_mode": False}),
    ("fused_adam", {"lr": 3e-3, "betas": [0.8, 0.95], "bias_correction": False}),
    ("Lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("adagrad", {"lr": 1e-1, "weight_decay": 0.01}),
    ("sgd", {"lr": 1e-1, "momentum": 0.9, "nesterov": True,
             "weight_decay": 0.01}),
    ("SGD", {"lr": 1e-1}),
]


def _tree(rng):
    return {"a": rng.randn(7, 5).astype(np.float32),
            "b": {"c": rng.randn(11).astype(np.float32),
                  "d": rng.randn(3, 4, 2).astype(np.float32)}}


def _flat_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name,params", OPTIMIZERS,
                         ids=[n for n, _ in OPTIMIZERS])
def test_optimizer_five_steps_match_jax(name, params):
    rng = np.random.RandomState(0)
    p0 = _tree(rng)
    jopt, topt = jadam.build_optimizer(name, params), tadam.build_optimizer(name, params)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = jax.tree_util.tree_map(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _tree(rng)
        lr = params["lr"] * (1 + 0.5 * step)
        jp, js = jopt.step(jp, jax.tree_util.tree_map(jnp.asarray, g), js,
                           jnp.asarray(lr, jnp.float32))
        tp, ts = topt.step(tp, jax.tree_util.tree_map(torch.from_numpy, g), ts, lr)
    for a, b in zip(tree_leaves(tp), _flat_np(jp)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7)
    assert ts.step == int(js.step) == 5
    for jfield, tfield in zip(js[1:], ts[1:]):
        for a, b in zip(tree_leaves(tfield), _flat_np(jfield)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ loss scaling
def test_loss_scaler_trajectory_matches_jax():
    kw = dict(init_scale=2.0 ** 10, scale_window=3, min_scale=4.0,
              delayed_shift=2)
    j, t = jprec.DynamicLossScaler(**kw), tprec.DynamicLossScaler(**kw)
    js, ts = j.init(), t.init()
    pattern = [0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 0, 0, 0, 0]
    for flag in pattern:
        js = j.update(js, jnp.asarray(bool(flag)))
        ts = t.update(ts, bool(flag))
        assert (ts.cur_scale, ts.cur_iter, ts.last_overflow_iter,
                ts.cur_hysteresis) == (float(js.cur_scale), int(js.cur_iter),
                                       int(js.last_overflow_iter),
                                       int(js.cur_hysteresis))
    st_j, st_t = jprec.StaticLossScaler(8.0), tprec.StaticLossScaler(8.0)
    a, b = st_j.update(st_j.init(), jnp.asarray(True)), st_t.update(st_t.init(), True)
    assert (b.cur_scale, b.cur_iter) == (float(a.cur_scale), int(a.cur_iter))


def test_grad_checks_match_jax():
    rng = np.random.RandomState(3)
    g = _tree(rng)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = jax.tree_util.tree_map(torch.from_numpy, g)
    np.testing.assert_allclose(float(tprec.global_grad_norm(tg)),
                               float(jprec.global_grad_norm(jg)), rtol=1e-6)
    for max_norm in (0.5, 1e3):
        jc, jn = jprec.clip_grads_by_global_norm(jg, max_norm)
        tc, tn = tprec.clip_grads_by_global_norm(tg, max_norm)
        for a, b in zip(tree_leaves(tc), _flat_np(jc)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)
    assert not bool(tprec.has_inf_or_nan(tg))
    g["b"]["d"][1, 2, 0] = np.inf
    assert bool(tprec.has_inf_or_nan(jax.tree_util.tree_map(torch.from_numpy, g)))
    assert bool(jprec.has_inf_or_nan(jax.tree_util.tree_map(jnp.asarray, g)))


# ------------------------------------------------------------------ engine
def _config(precision="fp32", **extra):
    cfg = {"train_batch_size": MICRO * GAS, "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
                                    "warmup_num_steps": 3}},
           "gradient_clipping": 1.0, "steps_per_print": 0, "seed": 11}
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    if precision == "fp16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 32,
                       "hysteresis": 1}
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


def _jax_engine(cfg, compute_dtype):
    model = JGPT2Model(JGPT2Config.tiny(max_seq_len=64), attn_impl="flash",
                       compute_dtype=compute_dtype)
    engine, *_ = deepspeed_tpu.initialize(
        model=model, config=JConfig(cfg, world_size=1),
        topology=MeshTopology(ParallelDims(), devices=jax.devices()[:1]))
    return engine


def _port_engine(cfg, compute_dtype, params):
    model = GPT2Model(GPT2Config.tiny(max_seq_len=64), attn_impl="flash",
                      compute_dtype=compute_dtype)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                device="cpu", params=params)
    return engine


def _train_both(precision, jdt, tdt, steps):
    cfg = _config(precision)
    jeng = _jax_engine(cfg, jdt)
    p0 = jax.device_get(jeng.state.params)
    teng = _port_engine(cfg, tdt, gpt2_params_from_numpy(p0, "cpu"))
    rows = []
    for batch in _batches(steps):
        jl = float(jax.device_get(jeng.train_batch_from_stacked(batch)))
        tl = float(teng.train_batch_from_stacked(batch))
        rows.append((jl, tl, jeng.get_global_grad_norm(),
                     teng.get_global_grad_norm()))
    return jeng, teng, p0, rows


def test_engine_fp32_tracks_jax():
    jeng, teng, _, rows = _train_both("fp32", jnp.float32, torch.float32, 4)
    for jl, tl, jn, tn in rows:
        assert abs(tl - jl) <= 1e-5 * abs(jl), rows
        assert abs(tn - jn) <= 1e-5 * abs(jn), rows
    assert rows[-1][0] < rows[0][0]                 # it learns
    assert teng.global_steps == jeng.global_steps == 4
    assert teng.state.global_step == int(jeng.state.global_step) == 4
    assert teng.get_lr() == jeng.get_lr()
    lr_bound = 2 * 1e-3 * 4
    jp = jax.tree_util.tree_leaves_with_path(jax.device_get(jeng.state.params))
    tp = numpy_from_params(teng.state.params)
    off = total = 0
    for path, want in jp:
        got = tp
        for key in path:
            got = got[key.key]
        diff = np.abs(got - np.asarray(want, np.float32))
        assert diff.max() <= lr_bound, (path, diff.max())
        off += int((diff > 1e-5).sum())
        total += diff.size
    assert off <= 2e-3 * total, (off, total)


def test_engine_bf16_tracks_jax():
    _, _, _, rows = _train_both("bf16", jnp.bfloat16, torch.bfloat16, 4)
    for jl, tl, jn, tn in rows:
        assert abs(tl - jl) <= 1e-3 * abs(jl), rows
        assert abs(tn - jn) <= 5e-3 * abs(jn), rows


def test_engine_fp16_overflow_skips_like_jax():
    jeng, teng, p0, rows = _train_both("fp16", jnp.bfloat16, torch.bfloat16, 2)
    assert teng.get_loss_scale() == jeng.get_loss_scale() == 2.0 ** 30
    assert teng.global_steps == jeng.global_steps == 2
    assert teng.state.global_step == int(jeng.state.global_step) == 0
    for jl, tl, _, _ in rows:
        assert abs(tl - jl) <= 1e-2 * abs(jl)
    # both updates skipped: the masters are the initial parameters
    for a, b in zip(tree_leaves(numpy_from_params(teng.state.params)),
                    _flat_np(p0)):
        np.testing.assert_array_equal(a, b)


def test_forward_backward_step_equals_train_batch():
    rng = np.random.RandomState(5)
    params = GPT2Model(GPT2Config.tiny(max_seq_len=64)).init(
        torch.Generator().manual_seed(rng.randint(1 << 30)))
    cfg = _config("fp32")
    fused = _port_engine(cfg, torch.float32, params)
    manual = _port_engine(cfg, torch.float32, params)
    for batch in _batches(2, seed=9):
        fused_loss = float(fused.train_batch_from_stacked(batch))
        losses = []
        for i in range(GAS):
            mb = {k: v[i] for k, v in batch.items()}
            loss = manual(mb)
            manual.backward(loss)
            assert manual.is_gradient_accumulation_boundary() == (i == GAS - 1)
            manual.step()
            losses.append(float(loss))
        assert np.mean(losses) == pytest.approx(fused_loss, rel=1e-6)
    assert manual.global_steps == fused.global_steps == 2
    assert manual.micro_steps == fused.micro_steps == 2 * GAS
    for a, b in zip(tree_leaves(manual.state.params), tree_leaves(fused.state.params)):
        assert torch.equal(a, b)


class _Dataset:
    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        start = rng.randint(0, VOCAB, size=(n, 1))
        step = rng.randint(1, 7, size=(n, 1))
        self.ids = ((start + step * np.arange(T + 1)) % VOCAB).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i, :-1], "labels": self.ids[i, 1:]}


def test_train_batch_from_the_engine_loader_matches_jax():
    cfg = _config("fp32")
    data = _Dataset(40, seed=2)
    model = JGPT2Model(JGPT2Config.tiny(max_seq_len=64), attn_impl="flash",
                       compute_dtype=jnp.float32)
    jeng, _, jloader, _ = deepspeed_tpu.initialize(
        model=model, config=JConfig(cfg, world_size=1), training_data=data,
        topology=MeshTopology(ParallelDims(), devices=jax.devices()[:1]))
    p0 = gpt2_params_from_numpy(jax.device_get(jeng.state.params), "cpu")
    teng, _, tloader, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config.tiny(max_seq_len=64), attn_impl="flash",
                        compute_dtype=torch.float32),
        config=cfg, training_data=data, device="cpu", params=p0)
    assert len(tloader) == len(jloader) == 10
    for _ in range(2):
        jl = float(jax.device_get(jeng.train_batch()))
        tl = float(teng.train_batch())
        assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert tloader.state_dict() == jloader.state_dict()


# -------------------------------------------------------------- dataloader
def test_dataloader_stream_and_state_dict_round_trip_match_jax():
    data = _Dataset(23, seed=4)
    jload = jdl.DeepSpeedDataLoader(data, 4, seed=3, drop_last=False)
    tload = tdl.DeepSpeedDataLoader(data, 4, seed=3, drop_last=False)
    jit, tit = iter(jdl.RepeatingLoader(jload)), iter(tdl.RepeatingLoader(tload))
    for _ in range(9):                         # across an epoch boundary
        a, b = next(jit), next(tit)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    state = tload.state_dict()
    assert state == jload.state_dict()
    resumed = tdl.DeepSpeedDataLoader(data, 4, seed=0, drop_last=False)
    resumed.load_state_dict(state)
    want = [next(tit) for _ in range(3)]
    got = iter(tdl.RepeatingLoader(resumed))
    for a in want:
        b = next(got)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(tdl.default_collate([np.ones(2), np.zeros(2)]),
                                  jdl.default_collate([np.ones(2), np.zeros(2)]))


# ------------------------------------------------------------ not ported
OPTIONS = [
    {"zero_optimization": {"stage": 1}},
    {"zero_optimization": {"stage": 3}},
    {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"cpu_offload": True}},
    {"pipeline": {"stages": 2}},
    {"tensor_parallel": {"tp_size": 2}, "train_batch_size": MICRO * GAS},
    {"sequence_parallel": {"sp_size": 2}},
    {"ep_size": 2},
    {"progressive_layer_drop": {"enabled": True}},
    {"data_efficiency": {"data_routing": {"random_ltd": {"enabled": True}}}},
    {"curriculum_learning": {"enabled": True}},
    {"tensorboard": {"enabled": True}},
    {"wandb": {"enabled": True}},
    {"csv_monitor": {"enabled": True}},
    {"jsonl_monitor": {"enabled": True}},
    {"flops_profiler": {"enabled": True}},
    {"zero_optimization": {"stage": 2}},
    {"comms_logger": {"enabled": True}},
    {"activation_checkpointing": {"cpu_checkpointing": True}},
    {"resilience": {"enabled": True}},
    {"elasticity": {"enabled": True}},
    {"activation_checkpointing": {"partition_activations": True}},
    {"activation_checkpointing": {"policy": "dots"}},
    {"optimizer": {"type": "cpu_adam", "params": {"lr": 1e-3}}},
    {"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3}}},
]
OPTION_IDS = [next(iter(e)) + f"-{i}" for i, e in enumerate(OPTIONS)]
# the activation_checkpointing section is parsed and, as in the reference,
# not read by the engine (runtime/activation_checkpointing.py)
ACCEPTED = [(e, i) for e, i in zip(OPTIONS, OPTION_IDS)
            if "activation_checkpointing" in e]
NOT_PORTED = [(e, i) for e, i in zip(OPTIONS, OPTION_IDS)
              if "activation_checkpointing" not in e]


@pytest.mark.parametrize("extra", [e for e, _ in NOT_PORTED],
                         ids=[i for _, i in NOT_PORTED])
def test_options_not_ported_raise(extra):
    cfg = _config("fp32", **extra)
    if "tensor_parallel" in extra or "sequence_parallel" in extra \
            or "pipeline" in extra:
        cfg["train_batch_size"] = MICRO * GAS * 1
        cfg.pop("gradient_accumulation_steps")
    model = GPT2Model(GPT2Config.tiny(max_seq_len=64))
    with pytest.raises(NotPortedError):
        deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")


@pytest.mark.parametrize("extra", [e for e, _ in ACCEPTED],
                         ids=[i for _, i in ACCEPTED])
def test_activation_checkpointing_options_are_accepted(extra):
    cfg = _config("fp32", **extra)
    assert TConfig(cfg).not_ported() == []
    model = GPT2Model(GPT2Config.tiny(max_seq_len=64))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                device="cpu")
    mine = engine.config.activation_checkpointing_config
    ref = JConfig(cfg, world_size=1).activation_checkpointing_config
    for key, value in extra["activation_checkpointing"].items():
        assert getattr(mine, key) == getattr(ref, key) == value


def test_hybrid_pipeline_and_checkpoints_not_ported():
    model = GPT2Model(GPT2Config.tiny(max_seq_len=64))
    with pytest.raises(NotPortedError):
        deepspeed_tpu_torch.initialize(model=model, device="cpu", config=_config(
            hybrid_engine={"enabled": True}))

    class PipelineModule:
        pass

    with pytest.raises(NotPortedError):
        deepspeed_tpu_torch.initialize(model=PipelineModule(), device="cpu",
                                       config=_config())
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, device="cpu",
                                                config=_config())
    # the checkpoint methods are ported (tests/test_torch_checkpoint.py)
    with tempfile.TemporaryDirectory() as d:
        assert engine.save_checkpoint(d) is True
        assert engine.load_checkpoint(d)[0].endswith("global_step0")
        assert engine.save_16bit_model(d).endswith("model_weights.npz")
    # an absent telemetry section is the reference's default, not a request
    assert TConfig(_config()).not_ported() == []


def test_initialize_defaults_to_the_card():
    model = GPT2Model(GPT2Config.tiny(max_seq_len=64))
    if torch.cuda.is_available():
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config())
        assert engine.device.type == "cuda"
        return
    with pytest.raises(DeviceUnavailableError):
        deepspeed_tpu_torch.initialize(model=model, config=_config())
