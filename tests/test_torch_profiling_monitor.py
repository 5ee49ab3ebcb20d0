"""The monitors and the FLOPs profiler in the port (deepspeed_tpu_torch/
monitor/, profiling/, ops/kernel_flops.py) against the JAX package's, on
the CPU.

Tolerances, and why:

* the monitors on the same events: the csv files byte for byte, the JSONL
  records equal but for their wall-clock stamp (the same formatting of
  the same values);
* ``get_model_profile`` at 1 layer with dense attention: the parameter
  count and the FLOPs exactly equal to the reference's
  ``jaxpr_op_breakdown(...)["dot_general"]["flops"]`` (both count 2 x
  M x N x K per product of the same shapes). At L layers the port counts
  every layer, the non-layer part plus L times the per-layer part,
  exactly; the reference's jaxpr counts the scanned body once;
* the kernels' reported work: exactly the analytic count (integer
  arithmetic), with their plain versions' products taken back out of the
  dispatch-level count on the CPU, exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.monitor import get_monitor_config as jget_monitor_config
from deepspeed_tpu.monitor.monitor import MonitorMaster as JMonitorMaster
from deepspeed_tpu.profiling import FlopsProfiler as JFlopsProfiler
from deepspeed_tpu.profiling import jaxpr_op_breakdown
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.monitor import get_monitor_config
from deepspeed_tpu_torch.monitor.monitor import MonitorMaster
from deepspeed_tpu_torch.ops import kernel_flops
from deepspeed_tpu_torch.ops.decode_step import fused_decode_step
from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.int8_matmul import int8_matmul_dma
from deepspeed_tpu_torch.profiling import (FlopsProfiler, count_flops,
                                           get_model_profile)
from deepspeed_tpu_torch.telemetry import read_jsonl

VOCAB, B, T = 256, 2, 16


def _cfg(layers):
    return dict(vocab_size=VOCAB, max_seq_len=64, num_layers=layers,
                hidden_size=64, num_heads=4)


def _batch():
    ids = np.random.RandomState(0).randint(0, VOCAB, (B, T)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def _torch_batch():
    return {k: torch.as_tensor(v).long() for k, v in _batch().items()}


# ------------------------------------------------------------- monitors
EVENTS = [("Train/Samples/train_loss", 6.2351, 1),
          ("Train/Samples/lr", 1e-4, 1),
          ("Train/Samples/train_loss", np.float32(5.5), 2),
          ("Train/Samples/loss_scale", 65536.0, 2)]


def test_monitors_write_the_references_files(tmp_path):
    out = {}
    for pkg, get, master in (("jax", jget_monitor_config, JMonitorMaster),
                             ("port", get_monitor_config, MonitorMaster)):
        root = str(tmp_path / pkg)
        cfg = get({"csv_monitor": {"enabled": True, "output_path": root,
                                   "job_name": "job"},
                   "jsonl_monitor": {"enabled": True, "output_path": root,
                                     "job_name": "job"},
                   "wandb": {"enabled": True}})
        mon = master(cfg)
        assert mon.enabled and mon.csv_monitor.enabled
        assert not mon.wandb_monitor.enabled      # no wandb: warns, disabled
        mon.write_events(EVENTS[:2])
        mon.write_events(EVENTS[2:])
        out[pkg] = (root, mon)
    jroot, troot = out["jax"][0], out["port"][0]
    names = sorted(os.listdir(os.path.join(jroot, "job")))
    assert sorted(os.listdir(os.path.join(troot, "job"))) == names == [
        "Train_Samples_loss_scale.csv", "Train_Samples_lr.csv",
        "Train_Samples_train_loss.csv"]
    for n in names:
        with open(os.path.join(jroot, "job", n), "rb") as f:
            want = f.read()
        with open(os.path.join(troot, "job", n), "rb") as f:
            assert f.read() == want, n

    def records(root):
        return [{k: v for k, v in r.items() if k != "ts"}
                for r in read_jsonl(os.path.join(root, "job.jsonl"))]

    assert records(troot) == records(jroot) and len(records(troot)) == 4
    assert out["port"][1].tb_monitor.enabled == out["jax"][1].tb_monitor.enabled


def test_monitor_config_and_disabled_writers():
    cfg = get_monitor_config({"tensorboard": {"output_path": "tb"},
                              "csv_monitor": {"job_name": "j"}})
    assert not cfg.enabled and cfg.tensorboard.output_path == "tb"
    assert cfg.csv_monitor.job_name == "j" and cfg.wandb.project
    mon = MonitorMaster(cfg)
    assert not mon.enabled
    mon.write_events(EVENTS)                      # nothing to write to


# ------------------------------------------------------------- profiler
def _port_count(layers, attn="dense"):
    model = GPT2Model(GPT2Config(**_cfg(layers)), compute_dtype=torch.float32,
                      attn_impl=attn)
    return get_model_profile(model, _torch_batch(), as_string=False), model


@pytest.fixture(scope="module")
def jax_one_layer():
    jm = JGPT2Model(JGPT2Config(**_cfg(1)), compute_dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    dots = jaxpr_op_breakdown(
        lambda p, b: jm.apply(p, b, rngs=None, train=False)[0],
        params, batch)["dot_general"]["flops"]
    return dots, JFlopsProfiler(model=jm).get_total_params()


def test_model_profile_at_one_layer_matches_the_reference(jax_one_layer):
    dots, n_params = jax_one_layer
    (flops, macs, params), model = _port_count(1)
    assert flops == dots and macs == flops / 2
    assert params == n_params
    assert FlopsProfiler(model=model).get_total_params() == n_params


def test_model_profile_counts_every_layer():
    """The port counts each layer; the reference's jaxpr counts its scanned
    layer body once (ROADMAP queue 3)."""
    counts = {n: _port_count(n)[0][0] for n in (1, 2, 4)}
    per_layer = counts[2] - counts[1]
    non_layer = counts[1] - per_layer
    c = GPT2Config(**_cfg(1))
    h, m = c.hidden_size, c.mlp_dim
    # the block's four weight products and q.k^T / p.V over all T x T
    assert per_layer == 2 * B * T * (3 * h * h + h * h + 2 * h * m) \
        + 2 * 2 * B * T * T * h
    assert non_layer == 2 * B * T * h * VOCAB            # tied logits
    assert counts[4] == non_layer + 4 * per_layer


def test_flash_kernels_report_their_work_and_nothing_twice():
    """With the flash kernels (their plain versions on the CPU), the count
    is the dense model's with the two attention einsums replaced by kernel
    D's reported work: q.k^T and p.V over the causal pairs."""
    layers = 2
    (dense, _, _), _ = _port_count(layers)
    model = GPT2Model(GPT2Config(**_cfg(layers)), compute_dtype=torch.float32,
                      attn_impl="flash")
    params = model.init(torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    cost = count_flops(lambda: model.apply(params, _torch_batch())[0])
    c = model.config
    pairs = kernel_flops.attn_pairs(T, T, True)
    fwd = 4 * B * c.num_heads * c.head_dim * pairs * layers
    assert cost["kernel_flops"] == {"flash_fwd_parts": fwd}
    assert cost["dispatch_flops"] == dense - layers * 2 * 2 * B * T * T * c.hidden_size
    assert cost["flops"] == cost["dispatch_flops"] + fwd
    # a training step: the backward's products and kernels E and F
    for leaf in jax.tree_util.tree_leaves(params):
        leaf.requires_grad_()
    step = count_flops(lambda: model.apply(params, _torch_batch())[0].backward())
    assert step["kernel_flops"] == {
        "flash_fwd_parts": fwd, "flash_bwd_dq": fwd * 3 // 2,
        "flash_bwd_dkv": fwd * 2}
    assert step["dispatch_flops"] == 3 * cost["dispatch_flops"]


def test_decode_and_int8_kernels_report_their_work():
    gen = torch.Generator().manual_seed(1)
    b, hq, hkv, s, dh = 3, 4, 2, 16, 64
    q = torch.randn(b, 1, hq, dh, generator=gen)
    kc = torch.randn(2, b, hkv, s, dh, generator=gen)
    vc = torch.randn(2, b, hkv, s, dh, generator=gen)
    kn = torch.randn(b, 1, hkv, dh, generator=gen)
    idx = torch.tensor([0, 7, 15], dtype=torch.int32)
    cost = count_flops(lambda: fused_decode_step(q, kc, vc, kn, kn, 1, idx))
    assert cost["kernel_flops"] == {
        "fused_decode_step": 4 * hq * dh * (1 + 8 + 16)}
    assert cost["dispatch_flops"] == 0           # the plain version's einsums
    x = torch.randn(5, 128, generator=gen)
    w = torch.randint(-127, 127, (2, 128, 256), dtype=torch.int8)
    sc = torch.rand(2, 1, 256, generator=gen)
    cost = count_flops(lambda: int8_matmul_dma(x, w, sc, 1))
    assert cost == {**cost, "flops": 2 * 5 * 128 * 256, "dispatch_flops": 0,
                    "kernel_flops": {"int8_matmul_dma": 2 * 5 * 128 * 256}}
    # no count open: the wrappers report nothing and cost nothing
    assert not kernel_flops.counting()
    flash_attention(*(torch.randn(1, 8, 2, 64) for _ in range(3)))


def test_flops_profiler_api(tmp_path):
    model = GPT2Model(GPT2Config(**_cfg(2)), compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    prof = FlopsProfiler(model=model)
    prof.start_profile()
    cost = prof.profile_fn(lambda p, b: model.apply(p, b)[0], params,
                           _torch_batch())
    prof.stop_profile()
    assert "out" not in cost and prof.get_total_flops() == cost["flops"] > 0
    assert prof.get_total_flops(as_string=True).endswith("FLOPs")
    assert prof.get_total_duration() > 0
    assert prof.get_total_params() == sum(
        t.numel() for t in jax.tree_util.tree_leaves(params))
    path = str(tmp_path / "profile.txt")
    text = prof.print_model_profile(output_file=path)
    assert open(path).read() == text + "\n" and "not counted" in text
    flops, macs, n = get_model_profile(model, _batch(), device="cpu")
    assert flops.endswith("FLOPs") and macs.endswith("MACs")
    # the section is accepted; the engine does not read it (as the
    # reference's)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu", params=params,
        config={"train_batch_size": 2, "flops_profiler": {
            "enabled": True, "profile_step": 2, "output_file": path}})
    assert eng.config.flops_profiler_config.profile_step == 2
    assert FlopsProfiler(ds_engine=eng).get_total_params() == \
        prof.get_total_params()
    eng.destroy()
