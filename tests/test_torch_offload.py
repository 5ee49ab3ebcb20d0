"""ZeRO-Offload and ZeRO-Infinity in the port (deepspeed_tpu_torch/
runtime/zero/offload.py, ops/cpu_adam_native.py, ops/native/builder.py,
the engine's host step and the ``host_opt`` checkpoint section) against
the JAX package's, on the CPU.

The port's counterparts of tests/unit/runtime/test_offload.py's one-rank
cases (the multi-host shard cases wait for the multi-rank slice). The
reference builds its own copy of the kernel source into a directory under
the repo's ``build/`` (``DSTPU_BUILD_DIR``); the port builds its copy into
``build/native``, with the same compiler and flags.

Tolerances, and why:

* the native kernels and ``HostOffloadOptimizer``, port against reference:
  masters, moments and images bit-identical (the same source built by the
  same compiler with the same flags, over the same values);
* each kernel's plain PyTorch version against the kernel: 1e-6 relative
  (the same operations in the same order; the compiler may fuse a
  multiply-add the plain version rounds twice), and 1e-6 x lr absolute
  where an update cancels a value to near zero (its terms are lr-sized;
  measured up to 3.3e-9), bf16 images within one bf16 ulp (2^-8
  relative: an f32 rounding apart may cross a bf16 rounding boundary);
* the engine, 3 steps against the reference's engine with the same config,
  init and batches: in fp32 loss and grad norm within 1e-5 relative (the
  training parity of tests/test_torch_training.py) and the host masters
  within 2 x lr x steps; in bf16 loss within 1e-3 and grad norm within
  5e-3 relative (bf16 rounding at different points in two libraries'
  forward and backward, as tests/test_torch_training.py holds);
* nvme against cpu, ZeRO stages 0-3, and forward/backward/step against
  train_batch, all in the port: bit-identical (the same arithmetic; the
  swap moves bytes, and one rank keeps every leaf whole);
* checkpoints across the packages: masters, moments, step and images
  bit-identical (the same stored bytes); the next loss within 1e-5
  relative (fp32, as above).
"""

import gc
import os
import re
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu.parallel.topology import MeshTopology, ParallelDims
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch.inference.weights import _to_tensor
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.ops import cpu_adam_native as tcna
from deepspeed_tpu_torch.ops.adam import Adagrad, FusedAdam
from deepspeed_tpu_torch.ops.native import builder as tbuilder
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.zero.config import (
    DeepSpeedZeroOffloadOptimizerConfig as TOffload)
from deepspeed_tpu_torch.runtime.zero.offload import (HostOffloadOptimizer,
                                                      param_names)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAS, MICRO, SEQ, VOCAB = 2, 4, 8, 64
LR = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _reference_build_dir():
    """The reference's native build lands under the repo's build/."""
    old = os.environ.get("DSTPU_BUILD_DIR")
    os.environ["DSTPU_BUILD_DIR"] = os.path.join(ROOT, "build", "native_reference")
    yield
    if old is None:
        os.environ.pop("DSTPU_BUILD_DIR", None)
    else:
        os.environ["DSTPU_BUILD_DIR"] = old


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------------ the kernels
KERNEL_CASES = {
    "adamw": dict(weight_decay=0.01, adamw_mode=True),
    "adam_l2": dict(weight_decay=0.01, adamw_mode=False),
    "adam_no_bias_correction": dict(bias_correction=False),
    "fused_f32_grad_scaled": dict(weight_decay=0.01, grad_scale=0.37),
    "fused_bf16_grad_and_image": dict(weight_decay=0.01, grad_scale=0.5,
                                      bf16_grad=True, emit_bf16=True),
    "adagrad": dict(adagrad=True, weight_decay=0.01),
}


def _kernel_inputs(n=3001, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(n).astype(np.float32) for _ in range(2)] + \
        [np.abs(rng.randn(n)).astype(np.float32) * 0.1 for _ in range(2)]


def _run_port(kw, arrays, step, plain=False):
    """The port's kernel (or its plain version) over copies of ``arrays``;
    returns the state and image as numpy."""
    p, g, m, v = [torch.from_numpy(a.copy()) for a in arrays]
    kw = dict(kw)
    if kw.pop("adagrad", False):
        (tcna.adagrad_step_plain if plain else tcna.adagrad_step)(
            p, g, v, lr=1e-2, **kw)
        return [p.numpy(), v.numpy()], None
    if kw.pop("bf16_grad", False):
        g = g.to(torch.bfloat16)
    fn = tcna.adam_step_fused_plain if plain else tcna.adam_step_fused
    img = fn(p, g, m, v, step=step, lr=1e-2, **kw)
    return [p.numpy(), m.numpy(), v.numpy()], img


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_native_kernels_match_the_reference_bit_for_bit(case):
    import ml_dtypes

    from deepspeed_tpu.ops import cpu_adam_native as jcna

    kw = dict(KERNEL_CASES[case])
    arrays = _kernel_inputs()
    for step in (1, 7):
        got, img = _run_port(kw, arrays, step)
        p, g, m, v = [a.copy() for a in arrays]
        jkw = dict(kw)
        if jkw.pop("adagrad", False):
            jcna.adagrad_step(p, g, v, lr=1e-2, **jkw)
            want, jimg = [p, v], None
        else:
            if jkw.pop("bf16_grad", False):
                g = g.astype(ml_dtypes.bfloat16)
            jimg = jcna.adam_step_fused(p, g, m, v, step=step, lr=1e-2, **jkw)
            want = [p, m, v]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        if img is not None:
            np.testing.assert_array_equal(_bits(img), _ref_bits(jimg))
    src = np.random.RandomState(3).randn(999).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(tcna.copy_f32_to_bf16(torch.from_numpy(src))),
        _ref_bits(jcna.copy_f32_to_bf16(src)))


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_plain_versions_match_the_kernels(case):
    kw = KERNEL_CASES[case]
    arrays = _kernel_inputs(seed=1)
    for step in (1, 7):
        got, img = _run_port(kw, arrays, step)
        want, pimg = _run_port(kw, arrays, step, plain=True)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * 1e-2)
        if img is not None:
            np.testing.assert_allclose(img.float().numpy(), pimg.float().numpy(),
                                       rtol=2 ** -8, atol=0)


def test_builder_flags_and_build_dir():
    b = deepspeed_tpu_torch.ops.get_op_builder("cpu_adam_native")()
    flags = b.build_flags()
    assert flags[1:6] == tbuilder.BASE_FLAGS and "-fopenmp" in flags
    assert any(f in flags for f, _ in tbuilder.SIMD_FLAGS)
    path = tbuilder.build_native_lib(b.NAME, b.SOURCES, True, True)
    assert path.parent == tbuilder.BUILD_DIR and path.exists()
    assert str(tbuilder.BUILD_DIR).startswith(os.path.join(ROOT, "build"))
    assert tcna.set_num_threads(0) >= 1


def test_no_compiler_raises_and_does_not_fall_back(monkeypatch):
    monkeypatch.setattr(tbuilder, "compiler", lambda: None)
    monkeypatch.setattr(tcna, "_LIB", None)
    with pytest.raises(tbuilder.NativeBuildError, match="no C\\+\\+ compiler"):
        HostOffloadOptimizer(FusedAdam(), TOffload(device="cpu"), torch.float32)
    model = GPT2Model(GPT2Config.tiny(max_seq_len=16))
    with pytest.raises(tbuilder.NativeBuildError):
        deepspeed_tpu_torch.initialize(model=model, config=_config(
            "fp32", offload="cpu"), device="cpu")
    assert not deepspeed_tpu_torch.ops.get_op_builder("async_io")().is_compatible()


# ------------------------------------------------ the host optimizer alone
HOST_CASES = [("adamw", "float32", "cpu"), ("adamw", "bfloat16", "cpu"),
              ("adam_l2", "bfloat16", "nvme"), ("adagrad", "float32", "cpu"),
              ("adagrad", "bfloat16", "nvme")]


def _optimizers(kind):
    from deepspeed_tpu.ops import adam as jadam

    if kind == "adagrad":
        return jadam.DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=0.01), \
            Adagrad(lr=1e-2, weight_decay=0.01)
    adamw = kind == "adamw"
    return jadam.FusedAdam(lr=1e-2, weight_decay=0.01, adam_w_mode=adamw), \
        FusedAdam(lr=1e-2, weight_decay=0.01, adam_w_mode=adamw)


@pytest.mark.parametrize("kind,dtype,device", HOST_CASES,
                         ids=["-".join(c) for c in HOST_CASES])
def test_host_optimizer_matches_the_reference(kind, dtype, device, tmp_path):
    from deepspeed_tpu.runtime.zero.config import (
        DeepSpeedZeroOffloadOptimizerConfig as JOffload)
    from deepspeed_tpu.runtime.zero.offload import HostOffloadOptimizer as JHost

    rng = np.random.RandomState(0)
    params = {"blocks": {"w": rng.randn(3, 16, 8).astype(np.float32)},
              "b": rng.randn(8).astype(np.float32)}
    jopt, topt = _optimizers(kind)
    nvme = {"nvme_path": str(tmp_path / "j")} if device == "nvme" else {}
    jh = JHost(jopt, JOffload(device=device, **nvme), getattr(jnp, dtype))
    jh.init(jax.tree_util.tree_map(jnp.asarray, params))
    nvme = {"nvme_path": str(tmp_path / "t")} if device == "nvme" else {}
    th = HostOffloadOptimizer(topt, TOffload(device=device, **nvme),
                              getattr(torch, dtype))
    th.init(jax.tree_util.tree_map(torch.from_numpy, params))
    assert th._names == jh._names == ["['b']", "['blocks']['w']"]
    for step, scale in enumerate((1.0, 0.3, 0.8)):
        grads = {n: rng.randn(*s).astype(np.float32)
                 for n, s in (("['b']", (8,)), ("['blocks']['w']", (3, 16, 8)))}
        jimg = jh.step(grads, lr=1e-2, grad_scale=scale)
        timg = th.step({n: torch.from_numpy(g) for n, g in grads.items()},
                       lr=1e-2, grad_scale=scale)
        for n in grads:
            assert timg[n].dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(_bits(timg[n]), _ref_bits(jimg[n]))
    jsd, tsd = jh.state_dict(), th.state_dict()
    assert jsd["step"] == tsd["step"] == 3
    for n, entry in jsd["state"].items():
        assert set(entry) == set(tsd["state"][n])
        for k, v in entry.items():
            np.testing.assert_array_equal(tsd["state"][n][k].numpy(), v)
    if device == "nvme":
        assert os.listdir(tmp_path / "t" / "optimizer")


def test_host_state_round_trip_and_layout_error():
    params = {"a": torch.randn(4, 3), "b": torch.randn(5)}
    h = HostOffloadOptimizer(FusedAdam(), TOffload(device="cpu"), torch.float32)
    h.init(params)
    h.step({"['a']": torch.ones(4, 3), "['b']": torch.ones(5)}, lr=0.1)
    template = h.state_template()
    assert set(template) == {"['a']", "['b']"}
    assert set(template["['a']"]) == {"master", "exp_avg", "exp_avg_sq"}
    sd = h.state_dict()
    h2 = HostOffloadOptimizer(FusedAdam(), TOffload(device="cpu"), torch.float32)
    h2.init(params)
    h2.load_state_dict({"step": sd["step"],
                        "state": {n: {k: v.clone() for k, v in e.items()}
                                  for n, e in sd["state"].items()}})
    assert h2.step_count == 1
    for n in sd["state"]:
        assert torch.equal(h2.master[n], h.master[n])
        assert torch.equal(h2.moments[n]["exp_avg_sq"], h.moments[n]["exp_avg_sq"])
    bad = {n: dict(e) for n, e in sd["state"].items()}
    bad["['b']"]["master"] = torch.zeros(6)
    with pytest.raises(ValueError, match="layout mismatch"):
        h2.load_state_dict({"step": 1, "state": bad})
    with pytest.raises(ValueError, match="adam/adamw/adagrad"):
        HostOffloadOptimizer(type("Lamb", (), {"name": "lamb"})(),
                             TOffload(device="cpu"), torch.float32)


def test_the_host_step_frees_what_it_was_given():
    """No reference cycle holds the parameters or the grads past a call:
    at LLaMA-7B a cycle in the name walk kept the 27 GB f32 init on the
    card until the garbage collector ran."""
    gc.disable()
    try:
        params = {"a": torch.randn(4, 3), "b": {"c": torch.randn(5)}}
        pref = weakref.ref(params["b"]["c"])
        h = HostOffloadOptimizer(FusedAdam(), TOffload(device="cpu"),
                                 torch.bfloat16)
        h.init(params)
        grads = param_names({"a": torch.ones(4, 3), "b": {"c": torch.ones(5)}})
        gref = weakref.ref(grads["['b']['c']"])
        h.step(grads, lr=0.1)
        del params, grads
        assert pref() is None and gref() is None
    finally:
        gc.enable()


# --------------------------------------------------------------- the engine
def _config(precision, offload=None, stage=2, optimizer="AdamW", **extra):
    zo = {"stage": stage}
    if offload is not None:
        zo["offload_optimizer"] = {"device": offload}
    cfg = {"train_batch_size": MICRO * GAS, "gradient_accumulation_steps": GAS,
           "optimizer": {"type": optimizer,
                         "params": {"lr": LR, "weight_decay": 0.01}},
           "zero_optimization": zo, "gradient_clipping": 1.0,
           "steps_per_print": 0, "seed": 3}
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    cfg.update(extra)
    return cfg


def _batch(i):
    rng = np.random.RandomState(40 + i)
    start = rng.randint(0, VOCAB, size=(GAS, MICRO, 1))
    step = rng.randint(1, 5, size=(GAS, MICRO, 1))
    ids = ((start + step * np.arange(SEQ + 1)) % VOCAB).astype(np.int32)
    return {"input_ids": ids[..., :-1], "labels": ids[..., 1:]}


def _models(family, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if family == "gpt2":
        kw = dict(vocab_size=VOCAB, max_seq_len=16)
        return (JGPT2Model(JGPT2Config.tiny(**kw), compute_dtype=jdt),
                GPT2Model(GPT2Config.tiny(**kw), compute_dtype=tdt))
    kw = dict(vocab_size=VOCAB, max_seq_len=16)
    return (JLlamaModel(JLlamaConfig.tiny(**kw), compute_dtype=jdt),
            LlamaModel(LlamaConfig.tiny(**kw), compute_dtype=tdt))


def _nested(flat):
    """Host masters by keystr name as the nested f32 parameter tree."""
    out = {}
    for name, arr in flat.items():
        *heads, last = re.findall(r"\['([^']*)'\]", name)
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = _to_tensor(arr, "cpu")
    return out


def _port_engine(family, dtype, cfg, params):
    _, model = _models(family, dtype)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                             device="cpu", params=params)
    return eng


RUNS = {"gpt2_fp32": ("gpt2", "float32", "fp32", 2),
        "llama_bf16": ("llama", "bfloat16", "bf16", 3)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per run: the reference's engine (offload cpu) trained 3 steps, with
    its losses, norms and host state; its initial masters; and the port's
    engines (offload cpu and nvme) trained on the same batches from them.
    The gpt2 run's reference engine then writes a tag and takes a 4th
    step."""
    root = tmp_path_factory.mktemp("offload")
    out = {}
    for name, (family, dtype, precision, stage) in RUNS.items():
        cfg = _config(precision, offload="cpu", stage=stage)
        jm, _ = _models(family, dtype)
        jeng, *_ = deepspeed_tpu.initialize(
            model=jm, config=JConfig(cfg, world_size=1),
            topology=MeshTopology(ParallelDims(), devices=jax.devices()[:1]))
        init = {n: np.array(m) for n, m in jeng._host_opt.master.items()}
        jrows = [(float(jax.device_get(jeng.train_batch_from_stacked(_batch(i)))),
                  jeng.get_global_grad_norm()) for i in range(3)]
        run = dict(jeng=jeng, init=init, jrows=jrows,
                   jmaster={n: np.array(m) for n, m in
                            jeng._host_opt.master.items()}, cfg=cfg)
        for device in ("cpu", "nvme"):
            tcfg = _config(precision, offload=device, stage=stage)
            if device == "nvme":
                tcfg["zero_optimization"]["offload_optimizer"]["nvme_path"] = \
                    str(root / f"{name}_nvme")
            teng = _port_engine(family, dtype, tcfg, _nested(init))
            run[device] = teng
            run[f"{device}_rows"] = [
                (float(teng.train_batch_from_stacked(_batch(i))),
                 teng.get_global_grad_norm()) for i in range(3)]
        if name == "gpt2_fp32":
            jeng.save_checkpoint(str(root / "jax"), tag="t3")
            run["jl4"] = float(jax.device_get(
                jeng.train_batch_from_stacked(_batch(3))))
        out[name] = run
    out["root"] = root
    yield out
    for name in RUNS:
        out[name]["jeng"].destroy()
        out[name]["cpu"].destroy()
        out[name]["nvme"].destroy()


@pytest.mark.parametrize("name", list(RUNS))
def test_offloaded_engine_tracks_the_reference(runs, name):
    run = runs[name]
    fp32 = RUNS[name][2] == "fp32"
    loss_tol, norm_tol = (1e-5, 1e-5) if fp32 else (1e-3, 5e-3)
    for (jl, jn), (tl, tn) in zip(run["jrows"], run["cpu_rows"]):
        assert abs(tl - jl) <= loss_tol * abs(jl), (run["jrows"], run["cpu_rows"])
        assert abs(tn - jn) <= norm_tol * abs(jn), (run["jrows"], run["cpu_rows"])
    teng = run["cpu"]
    assert teng._host_opt.step_count == 3 == teng.state.global_step
    assert all(p.dtype == getattr(torch, RUNS[name][1])
               for p in param_names(teng.state.params).values())
    if fp32:
        for n, want in run["jmaster"].items():
            got = teng._host_opt.master[n].numpy()
            assert np.abs(got - want).max() <= 2 * LR * 3, n


@pytest.mark.parametrize("name", list(RUNS))
def test_nvme_matches_cpu_bit_for_bit(runs, name):
    run = runs[name]
    assert run["nvme_rows"] == run["cpu_rows"]
    cpu, nvme = run["cpu"], run["nvme"]
    assert nvme._host_opt._swapper is not None and not nvme._host_opt.master
    sd = nvme._host_opt.state_dict()
    for n, entry in sd["state"].items():
        assert torch.equal(entry["master"], cpu._host_opt.master[n])
        assert torch.equal(entry["exp_avg"], cpu._host_opt.moments[n]["exp_avg"])
    for a, b in zip(param_names(cpu.state.params).values(),
                    param_names(nvme.state.params).values()):
        assert torch.equal(a, b)
    stats = nvme._host_opt.stats
    assert stats["nvme_read_bytes"] == stats["nvme_write_bytes"] > 0


@pytest.mark.parametrize("offload", [None, "cpu"])
def test_zero_stages_give_equal_losses_on_one_rank(offload):
    params = GPT2Model(GPT2Config.tiny(vocab_size=VOCAB, max_seq_len=16),
                       compute_dtype=torch.float32).init(
        torch.Generator().manual_seed(0))
    losses = []
    for stage in range(4):
        eng = _port_engine("gpt2", "float32",
                           _config("fp32", offload=offload, stage=stage), params)
        assert eng.zero_optimization_stage() == stage
        losses.append([float(eng.train_batch_from_stacked(_batch(i)))
                       for i in range(2)])
    assert losses[1:] == losses[:1] * 3


def test_forward_backward_step_matches_train_batch():
    params = LlamaModel(LlamaConfig.tiny(vocab_size=VOCAB, max_seq_len=16),
                        compute_dtype=torch.bfloat16).init(
        torch.Generator().manual_seed(1), device="cpu", dtype=torch.float32)
    cfg = _config("bf16", offload="cpu", stage=3)
    a = _port_engine("llama", "bfloat16", cfg, params)
    b = _port_engine("llama", "bfloat16", cfg, params)
    for i in range(2):
        la = float(a.train_batch_from_stacked(_batch(i)))
        batch = _batch(i)
        for g in range(GAS):
            loss = b({k: v[g] for k, v in batch.items()})
            b.backward(loss)
            b.step()
        assert a.get_global_grad_norm() == b.get_global_grad_norm()
    for n in a._host_opt.master:
        assert torch.equal(a._host_opt.master[n], b._host_opt.master[n])
    assert b.global_steps == 2 and b.state.global_step == 2


def test_fp16_overflow_skips_the_host_update():
    params = GPT2Model(GPT2Config.tiny(vocab_size=VOCAB, max_seq_len=16)).init(
        torch.Generator().manual_seed(2))
    cfg = _config("fp32", offload="cpu",
                  fp16={"enabled": True, "initial_scale_power": 32,
                        "hysteresis": 1})
    eng = _port_engine("gpt2", "float16", cfg, params)
    before = {n: m.clone() for n, m in eng._host_opt.master.items()}
    eng.train_batch_from_stacked(_batch(0))
    assert eng.skipped_steps == 1 and eng.state.global_step == 0
    assert eng.get_loss_scale() == 2.0 ** 31 and eng._host_opt.step_count == 0
    for n, m in eng._host_opt.master.items():
        assert torch.equal(m, before[n])


def test_attribution_counts_no_device_state_under_offload():
    """train_step_attribution's bytes: with the masters and moments on the
    host, the card moves the images (read by the forward and the backward,
    written by the upload) and the f32 grads (read by the download)."""
    params = GPT2Model(GPT2Config.tiny(vocab_size=VOCAB, max_seq_len=16)).init(
        torch.Generator().manual_seed(5))
    n = sum(t.numel() for t in param_names(params).values())
    got = {}
    for offload in (None, "cpu"):
        eng = _port_engine("gpt2", "float32",
                           _config("bf16", offload=offload,
                                   wall_clock_breakdown=True), params)
        eng.train_batch_from_stacked(_batch(0))
        eng._train_step_flops(GAS * MICRO * SEQ, SEQ)
        got[offload] = eng._telemetry_bytes
        assert eng.timers("step").elapsed() > 0
        eng.destroy()
    assert got["cpu"] == (3 * 2 + 4) * n
    assert got[None] > got["cpu"]           # f32 masters read and written


# ------------------------------------------------------------ checkpoints
def test_a_reference_tag_loads_into_the_port(runs):
    run = runs["gpt2_fp32"]
    teng = _port_engine("gpt2", "float32", run["cfg"], _nested(run["init"]))
    teng.load_checkpoint(str(runs["root"] / "jax"), tag="t3")
    data = np.load(runs["root"] / "jax" / "t3" / "state.npz")
    meta = __import__("json").loads(str(data["__meta__"]))
    assert teng._host_opt.step_count == meta["host_opt_step"] == 3
    keys = [k for k in data.files if k.startswith("host_opt::")]
    assert len(keys) == 3 * len(teng._host_opt.master)
    for key in keys:
        name, state = key[len("host_opt::"):].split("/")
        got = teng._host_opt.master[name] if state == "master" \
            else teng._host_opt.moments[name][state]
        np.testing.assert_array_equal(got.numpy(), data[key])
    l4 = float(teng.train_batch_from_stacked(_batch(3)))
    assert abs(l4 - run["jl4"]) <= 1e-5 * abs(run["jl4"])
    teng.destroy()


def test_a_port_tag_loads_into_the_reference(runs, tmp_path):
    run = runs["gpt2_fp32"]
    teng = run["cpu"]                       # 3 steps, offloaded
    teng.save_checkpoint(str(tmp_path), tag="p3")
    jm, _ = _models("gpt2", "float32")
    jeng, *_ = deepspeed_tpu.initialize(
        model=jm, config=JConfig(run["cfg"], world_size=1),
        topology=MeshTopology(ParallelDims(), devices=jax.devices()[:1]))
    jeng.load_checkpoint(str(tmp_path), tag="p3")
    assert jeng._host_opt.step_count == teng._host_opt.step_count == 3
    for n, m in teng._host_opt.master.items():
        np.testing.assert_array_equal(jeng._host_opt.master[n], m.numpy())
        for k, v in teng._host_opt.moments[n].items():
            np.testing.assert_array_equal(jeng._host_opt.moments[n][k], v.numpy())
    jl = float(jax.device_get(jeng.train_batch_from_stacked(_batch(3))))
    tl = float(teng.train_batch_from_stacked(_batch(3)))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    jeng.destroy()


def _within_one_step(img, base):
    """``img`` one AdamW step (|update| <= ~lr) and two bf16 roundings (the
    re-seeded master, the image) from ``base``: what a step from re-seeded
    masters gives, where one from stale masters of another init would not."""
    img, base = img.float(), base.float()
    return bool(((img - base).abs() <= 1.1 * LR + 2 ** -7 * base.abs()).all())


def test_module_only_load_reseeds_the_masters(runs, tmp_path):
    run = runs["llama_bf16"]
    trained = run["cpu"]
    trained.save_checkpoint(str(tmp_path / "off"), tag="t")
    fresh = _port_engine("llama", "bfloat16", run["cfg"], None)   # other init
    fresh.load_checkpoint(str(tmp_path / "off"), tag="t", load_module_only=True)
    assert fresh._host_opt.step_count == 0
    want = param_names(trained.state.params)
    for n, img in param_names(fresh.state.params).items():
        assert torch.equal(img, want[n])
        assert torch.equal(fresh._host_opt.master[n], img.float())
        assert not fresh._host_opt.moments[n]["exp_avg"].any()
    fresh.train_batch_from_stacked(_batch(3))
    for n, img in param_names(fresh.state.params).items():
        assert _within_one_step(img, want[n]), n
    # a tag saved without offload re-seeds them too
    dense = _port_engine("llama", "bfloat16", _config("bf16"), _nested(run["init"]))
    dense.train_batch_from_stacked(_batch(0))
    dense.save_checkpoint(str(tmp_path / "dense"), tag="t")
    fresh.load_checkpoint(str(tmp_path / "dense"), tag="t")
    want = param_names(dense.state.params)
    for n, img in param_names(fresh.state.params).items():
        assert torch.equal(fresh._host_opt.master[n], want[n].to(img.dtype).float())
    fresh.train_batch_from_stacked(_batch(1))
    for n, img in param_names(fresh.state.params).items():
        assert _within_one_step(img, want[n]), n


# ----------------------------------------------------------------- configs
def test_offload_param_is_accepted_and_not_read():
    cfg = _config("fp32", zero_optimization={
        "stage": 3, "offload_param": {"device": "cpu"}})
    from deepspeed_tpu.runtime.config import DeepSpeedConfig

    ref = DeepSpeedConfig(cfg, world_size=1).zero_config.offload_param
    mine = TConfig(cfg).zero_config.offload_param
    assert mine.device == ref.device == "cpu"
    assert TConfig(cfg).not_ported() == []
    eng = _port_engine("gpt2", "float32", cfg, None)
    assert eng._host_opt is None and not eng.offload_optimizer
    assert all(p.dtype == torch.float32 for p in param_names(eng.state.params).values())


def test_cpu_adam_is_accepted_with_and_without_offload():
    params = GPT2Model(GPT2Config.tiny(vocab_size=VOCAB, max_seq_len=16)).init(
        torch.Generator().manual_seed(4))
    losses = {}
    for opt, offload in (("cpu_adam", "cpu"), ("DeepSpeedCPUAdam", None),
                         ("Adam", None)):
        eng = _port_engine("gpt2", "float32",
                           _config("fp32", offload=offload, optimizer=opt),
                           params)
        assert (eng._host_opt is not None) == (offload is not None)
        losses[opt] = [float(eng.train_batch_from_stacked(_batch(i)))
                       for i in range(2)]
    assert losses["DeepSpeedCPUAdam"] == losses["Adam"]
    np.testing.assert_allclose(losses["cpu_adam"], losses["Adam"], rtol=1e-5)
