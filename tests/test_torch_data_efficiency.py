"""Data efficiency in the port (deepspeed_tpu_torch/runtime/
progressive_layer_drop.py, runtime/data_pipeline/, GPT-2's LTD and PLD
branches and the engine's wiring) against the JAX package's, on the CPU.

Both sides run GPT-2 at tiny widths (3-4 layers, hidden 64, dropout 0):
the JAX package on its CPU backend, the port with ``device="cpu"``, from
one parameter init and the same seeded batches.

Tolerances, and why:

* the schedules (PLD theta and per-layer keep probabilities, the four
  curriculum schedules, random-LTD's kept tokens) over steps 0-2000, the
  sampler's batches, the indexed dataset's files and reads in both
  directions, the analyzer's arrays, gather and scatter on given indices:
  exact (the same host arithmetic, or a copy of the same values);
* the model's LTD and PLD forward and gradients in fp32 with the draws
  fixed (the same sorted indices patched into both packages'
  ``sample_token_indices``; PLD at theta 1, all kept, and at theta 0 with
  2 layers, layer 1 dropped): within 1e-5 of the reference, relative to
  the largest element of each output or gradient (the same f32 products
  summed in another order);
* random draws (the port's PLD keeps, LTD's index draws): in distribution
  only, as torch's generator gives other bits than JAX's: a chi-squared
  test against the keep probability or the uniform position law, p > 1e-3
  on a fixed seed;
* the engine, 3 steps against the reference's engine on the same batches
  in fp32 (random-LTD with the curriculum and the csv and JSONL monitors;
  PLD; and the port's offload_optimizer cpu path with random-LTD and the
  curriculum against the reference's device-state rows), the draws fixed
  where random (LTD's indices patched as above; PLD's Bernoulli draw
  replaced on both sides by the rule "kept when p_keep >= 0.9"): losses,
  grad norms and monitor values within 1e-4 relative (the training parity
  of tests/test_torch_training.py, with room for the changed shapes and
  the host Adam's rounding);
* the step's FLOPs (the port's repair): exact (the same host formula).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import deepspeed_tpu
import deepspeed_tpu.runtime.data_pipeline.random_ltd as jltd
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models.gpt2 as tgpt2
import deepspeed_tpu_torch.runtime.data_pipeline.random_ltd as tltd
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.parallel.topology import MeshTopology, ParallelDims
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.data_pipeline import curriculum_scheduler as jcs
from deepspeed_tpu.runtime.data_pipeline import data_analyzer as jda
from deepspeed_tpu.runtime.data_pipeline import data_sampler as jds
from deepspeed_tpu.runtime.data_pipeline import indexed_dataset as jid
from deepspeed_tpu_torch.inference.weights import gpt2_params_from_numpy
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.data_pipeline import curriculum_scheduler as tcs
from deepspeed_tpu_torch.runtime.data_pipeline import data_analyzer as tda
from deepspeed_tpu_torch.runtime.data_pipeline import data_sampler as tds
from deepspeed_tpu_torch.runtime.data_pipeline import indexed_dataset as tid
from deepspeed_tpu_torch.telemetry import read_jsonl

VOCAB, T, MICRO, GAS = 256, 32, 2, 2
FWD_TOL = 1e-5          # model forward and grads, relative to each max
ENGINE_TOL = 1e-4       # engine losses, grad norms and monitor values
PLD_KEEP_AT = 0.9       # the fixed PLD rule of the engine runs
STEPS = range(0, 2001)


def _cfg(layers, **kw):
    return dict(vocab_size=VOCAB, max_seq_len=64, num_layers=layers,
                hidden_size=64, num_heads=4, **kw)


def _batch(i, t=T, b=MICRO, gas=None):
    rng = np.random.RandomState(100 + i)
    shape = (b, t + 1) if gas is None else (gas, b, t + 1)
    ids = rng.randint(0, VOCAB, size=shape).astype(np.int32)
    return {"input_ids": ids[..., :-1], "labels": ids[..., 1:]}


def _fixed_indices(b, t, keep):
    """The draws patched into both packages: one sorted subset per row
    from a fixed seed (the same at every call)."""
    rng = np.random.RandomState(7)
    return np.stack([np.sort(rng.permutation(t)[:keep]) for _ in range(b)])


def _patch_ltd(mp):
    mp.setattr(jltd, "sample_token_indices",
               lambda rng, b, t, keep: jnp.asarray(_fixed_indices(b, t, keep)))
    mp.setattr(tltd, "sample_token_indices",
               lambda gen, b, t, keep, device=None: torch.as_tensor(
                   _fixed_indices(b, t, keep), dtype=torch.long, device=device))


def _patch_pld(mp):
    """PLD's draw on both sides: kept when p_keep >= PLD_KEEP_AT."""
    mp.setattr(jax.random, "bernoulli",
               lambda key, p=0.5, shape=None: jnp.asarray(p) >= PLD_KEEP_AT)
    mp.setattr(tgpt2, "_pld_keep",
               lambda p, gen, device: torch.tensor(p >= PLD_KEEP_AT,
                                                   device=device))


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err)


# ------------------------------------------------------------ schedules
def test_pld_schedule_and_keep_probs_match_reference():
    for theta, gamma in ((0.5, 0.001), (0.2, 0.01), (0.9, 0.0)):
        j, t = jpld.ProgressiveLayerDrop(theta, gamma), \
            tpld.ProgressiveLayerDrop(theta, gamma)
        assert t.get_theta() == j.get_theta() == 1.0
        for step in STEPS:
            assert t.update_state(step) == j.update_state(step)
        assert t.get_state() == j.get_state()
    for layers in (1, 2, 5, 36):
        for theta in (0.0, 0.3, 1.0):
            np.testing.assert_array_equal(tpld.layer_keep_probs(layers, theta),
                                          jpld.layer_keep_probs(layers, theta))


CURRICULA = {
    "fixed_linear": {"schedule_type": "fixed_linear", "schedule_config": {
        "min_difficulty": 8, "max_difficulty": 1024,
        "total_curriculum_step": 1500, "difficulty_step": 8}},
    "fixed_root": {"schedule_type": "fixed_root", "schedule_config": {
        "min_difficulty": 64, "max_difficulty": 2048,
        "total_curriculum_step": 900, "difficulty_step": 16,
        "root_degree": 3}},
    "fixed_discrete": {"schedule_type": "fixed_discrete", "schedule_config": {
        "min_difficulty": 1, "max_difficulty": 3,
        "difficulty": [1, 2, 3], "max_step": [100, 700]}},
    "custom": {"curriculum_type": "custom", "min_difficulty": 4,
               "max_difficulty": 512},
}


@pytest.mark.parametrize("name", list(CURRICULA))
def test_curriculum_schedules_match_reference(name):
    j, t = jcs.CurriculumScheduler(CURRICULA[name]), \
        tcs.CurriculumScheduler(CURRICULA[name])
    if name == "custom":
        fn = lambda s: 4 + (s * 7) % 600                    # noqa: E731
        j.set_custom_get_difficulty(fn)
        t.set_custom_get_difficulty(fn)
    assert t.get_current_difficulty() == j.get_current_difficulty()
    for step in STEPS:
        assert t.update_difficulty(step) == j.update_difficulty(step), step
        assert t.get_difficulty(step) == j.get_difficulty(step)
    assert t.state_dict() == j.state_dict()
    t2 = tcs.CurriculumScheduler(CURRICULA[name])
    t2.load_state_dict(j.state_dict())
    assert t2.get_current_difficulty() == j.get_current_difficulty()


LTD_SCHEDULES = [
    {"random_ltd": {"random_ltd_schedule": {
        "min_value": 128, "max_value": 2048,
        "schedule_config": {"seq_per_step": 16,
                            "total_layer_tokens_steps": 1700}}}},
    {"min_value": 64, "max_value": 512, "total_steps": 300, "increment": 32},
    {},
]


@pytest.mark.parametrize("i", range(len(LTD_SCHEDULES)))
def test_random_ltd_scheduler_matches_reference(i):
    j, t = jltd.RandomLTDScheduler(LTD_SCHEDULES[i]), \
        tltd.RandomLTDScheduler(LTD_SCHEDULES[i])
    for step in STEPS:
        assert t.update_seq(step) == j.update_seq(step), step
    assert t.state_dict() == j.state_dict()
    t.load_state_dict({"current_seq": 96})
    assert t.get_current_seq() == 96


# --------------------------------------------------------- data pipeline
def test_data_sampler_batches_match_reference_bit_for_bit():
    diffs = np.random.RandomState(3).randint(1, 1024, size=500)
    cur = CURRICULA["fixed_linear"]
    j = jds.DeepSpeedDataSampler(diffs, 16, jcs.CurriculumScheduler(cur),
                                 seed=11, data_parallel_size=2,
                                 global_rank=1)
    t = tds.DeepSpeedDataSampler(diffs, 16, tcs.CurriculumScheduler(cur),
                                 seed=11, data_parallel_size=2,
                                 global_rank=1)
    for step in range(60):
        want, got = j.next_batch_indices(), t.next_batch_indices()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t.local_slice(got), j.local_slice(want))
    assert t.state_dict() == j.state_dict()
    it_j, it_t = iter(j), iter(t)
    for _ in range(5):
        np.testing.assert_array_equal(next(it_t), next(it_j))
    t2 = tds.DeepSpeedDataSampler(diffs, 16, tcs.CurriculumScheduler(cur),
                                  seed=11)
    t2.load_state_dict(j.state_dict())
    assert t2.global_step == j.global_step


def _docs(dtype, seed=0):
    rng = np.random.RandomState(seed)
    hi = np.iinfo(dtype).max if np.issubdtype(dtype, np.integer) else 100
    return [[rng.randint(0, min(hi, 60000), size=rng.randint(1, 40))
             .astype(dtype) for _ in range(rng.randint(1, 4))]
            for _ in range(12)]


def _write(builder_cls, prefix, docs, dtype):
    b = builder_cls(prefix, dtype=dtype)
    for doc in docs:
        for seq in doc:
            b.add_item(seq)
        b.end_document()
    b.finalize()


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.int64])
def test_indexed_dataset_round_trips_both_ways(tmp_path, writer, dtype):
    docs = _docs(dtype)
    flat = [s for d in docs for s in d]
    w, r = (tid, jid) if writer == "port" else (jid, tid)
    _write(w.MMapIndexedDatasetBuilder, str(tmp_path / "w"), docs, dtype)
    # the other package's builder writes the same bytes
    _write(r.MMapIndexedDatasetBuilder, str(tmp_path / "r"), docs, dtype)
    for suffix in (".bin", ".idx"):
        assert (tmp_path / f"w{suffix}").read_bytes() == \
            (tmp_path / f"r{suffix}").read_bytes()
    ds = r.MMapIndexedDataset(str(tmp_path / "w"))
    assert r.MMapIndexedDataset.exists(str(tmp_path / "w"))
    assert len(ds) == len(flat) and ds.dtype == np.dtype(dtype)
    for i, seq in enumerate(flat):
        np.testing.assert_array_equal(ds[i], seq)
        if seq.size > 2:
            np.testing.assert_array_equal(ds.get(i, 1, seq.size - 2), seq[1:-1])
    np.testing.assert_array_equal(ds.sizes, [s.size for s in flat])
    np.testing.assert_array_equal(
        ds.doc_idx, np.cumsum([0] + [len(d) for d in docs]))
    with pytest.raises(IndexError):
        ds.get(0, 0, int(ds.sizes[0]) + 1)


def test_data_analyzer_matches_reference(tmp_path):
    rng = np.random.RandomState(5)
    data = [rng.randint(0, 50, size=rng.randint(1, 30)) for _ in range(41)]
    freq = np.bincount(np.concatenate(data), minlength=50).astype(np.float64)
    names = ["seqlen", "rarity"]
    out = {}
    for pkg, mod in (("jax", jda), ("port", tda)):
        fns = [mod.seqlen_metric,
               lambda s, m=mod: m.vocab_rarity_metric(s, freq)]
        path = str(tmp_path / pkg)
        for w in range(3):
            mod.DataAnalyzer(data, names, fns, output_path=path, num_workers=3,
                             worker_id=w, num_threads=2).run_map()
        files = mod.DataAnalyzer(data, names, fns, output_path=path,
                                 num_workers=3).run_reduce()
        out[pkg] = {n: {k: np.load(v) for k, v in files[n].items()}
                    for n in names}
        out[pkg]["loaded"] = mod.load_difficulties(path, "rarity")
    for n in names:
        for k in ("sample_to_metric", "metric_to_sample"):
            np.testing.assert_array_equal(out["port"][n][k], out["jax"][n][k])
    np.testing.assert_array_equal(out["port"]["loaded"], out["jax"]["loaded"])
    assert tda.vocab_rarity_metric(data[0]) == 0.0
    with pytest.raises(ValueError):
        tda.DataAnalyzer(data, ["rarity"])
    with pytest.raises(FileNotFoundError):
        tda.DataAnalyzer(data, output_path=str(tmp_path / "none"),
                         num_workers=2).run_reduce()


# -------------------------------------------------------------- routing
def test_gather_scatter_match_reference_exactly():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 10, 8).astype(np.float32)
    kept = rng.randn(3, 4, 8).astype(np.float32)
    idx = _fixed_indices(3, 10, 4)
    g = tltd.gather_tokens(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(g.numpy(), np.asarray(
        jltd.gather_tokens(jnp.asarray(x), jnp.asarray(idx))))
    s = tltd.scatter_tokens(torch.from_numpy(x), torch.from_numpy(kept),
                            torch.from_numpy(idx))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jltd.scatter_tokens(
        jnp.asarray(x), jnp.asarray(kept), jnp.asarray(idx))))
    kept_t, idx_t = tltd.random_ltd_token_drop(
        torch.from_numpy(x), torch.Generator().manual_seed(0), 4)
    np.testing.assert_array_equal(kept_t.numpy(),
                                  np.take_along_axis(x, idx_t.numpy()[..., None], 1))


def _models(layers):
    jm = JGPT2Model(JGPT2Config(**_cfg(layers)), compute_dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(layers)))
    return jm, params


def _jax_loss_grads(jm, params, batch, **kw):
    def f(p, b):
        return jm.apply(p, b, rngs={"dropout": jax.random.PRNGKey(0)},
                        train=True, **kw)[0]

    loss, grads = jax.jit(jax.value_and_grad(f))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.device_get(grads)


@pytest.fixture(scope="module")
def ltd_reference():
    """The reference's LTD loss and grads (4 layers, keep 12 of 32) with the
    draws fixed, shared by the port's variants."""
    with pytest.MonkeyPatch.context() as mp:
        _patch_ltd(mp)
        jm, params = _models(4)
        return params, _jax_loss_grads(jm, params, _batch(0), ltd_keep=12)


def _port_loss_grads(layers, params, batch, **kw):
    attn, remat = kw.pop("attn_impl", "dense"), kw.pop("remat", False)
    m = GPT2Model(GPT2Config(**_cfg(layers)), compute_dtype=torch.float32,
                  attn_impl=attn, remat=remat)
    p = gpt2_params_from_numpy(params, "cpu")
    for leaf in jax.tree_util.tree_leaves(p):
        leaf.requires_grad_()
    loss, _ = m.apply(p, {k: torch.as_tensor(v).long() for k, v in batch.items()},
                      rngs={"dropout": torch.Generator().manual_seed(0)},
                      train=True, **kw)
    loss.backward()
    grads = jax.tree_util.tree_map(lambda t: t.grad.numpy(), p)
    return float(loss.detach()), grads


def _hold(port, ref, what):
    _close(port[0], ref[0], FWD_TOL, (what, "loss"))
    for path, want in jax.tree_util.tree_leaves_with_path(ref[1]):
        got = port[1]
        for k in path:
            got = got[k.key]
        _close(got, want, FWD_TOL, (what, jax.tree_util.keystr(path)))


@pytest.mark.parametrize("variant", ["dense", "flash", "dense_remat"])
def test_ltd_forward_and_grads_match_reference_with_fixed_draws(
        monkeypatch, ltd_reference, variant):
    _patch_ltd(monkeypatch)
    params, ref = ltd_reference
    batch = _batch(0)
    kw = {"attn_impl": "flash"} if variant == "flash" else {}
    if variant == "dense_remat":
        kw["remat"] = True
    port = _port_loss_grads(4, params, batch, ltd_keep=12, **kw)
    _hold(port, ref, variant)
    # the routing is real: every token kept is the plain model
    full = _port_loss_grads(4, params, batch)
    assert abs(full[0] - port[0]) > 1e-4


@pytest.fixture(scope="module")
def pld_reference():
    """The reference's PLD step of a 2-layer model, compiled once with
    theta an argument."""
    jm, params = _models(2)
    batch = {k: jnp.asarray(v) for k, v in _batch(1).items()}

    def f(p, theta):
        return jm.apply(p, batch, rngs={"dropout": jax.random.PRNGKey(0)},
                        train=True, pld_theta=theta)[0]

    step = jax.jit(jax.value_and_grad(f))
    return params, lambda theta: jax.device_get(step(params, jnp.float32(theta)))


@pytest.mark.parametrize("theta", [1.0, 0.0])
def test_pld_forward_and_grads_match_reference(pld_reference, theta):
    """theta 1: every block kept; theta 0: layer 0 kept, layer 1 dropped."""
    params, run = pld_reference
    loss, grads = run(theta)
    ref = (float(loss), grads)
    port = _port_loss_grads(2, params, _batch(1), pld_theta=theta)
    _hold(port, ref, theta)
    if theta == 0.0:
        # layer 1 dropped: its gradients are zero
        assert all(not np.any(g[1]) for g in port[1]["blocks"].values())


def test_pld_keep_frequencies_follow_layer_keep_probs():
    m = GPT2Model(GPT2Config(**_cfg(5)))
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(())
    theta, n = 0.3, 3000
    probs = tpld.layer_keep_probs(5, theta)
    f32 = np.float32
    for i, p in enumerate(probs):
        gates = torch.stack([m._pld_gate(i, theta, gen, x) for _ in range(n)])
        kept = int((gates != 0).sum())
        # a kept block's gate is 1 / p_keep, with p_keep in f32
        p32 = f32(1) - f32(i) / f32(4) * (f32(1) - f32(theta))
        assert torch.all((gates == 0) | (gates == f32(1) / p32))
        if p >= 1.0:
            assert kept == n
        else:
            assert stats.chisquare([kept, n - kept],
                                   [n * p, n * (1 - p)]).pvalue > 1e-3, (i, p)
    keep, pr = tpld.sample_layer_mask(gen, 5, theta)
    assert keep.dtype == torch.bool and torch.allclose(
        pr, torch.as_tensor(probs, dtype=torch.float32))


def test_ltd_index_draws_are_uniform_sorted_subsets():
    gen = torch.Generator().manual_seed(0)
    b, t, keep = 4000, 16, 5
    idx = tltd.sample_token_indices(gen, b, t, keep)
    assert idx.shape == (b, keep) and idx.dtype == torch.long
    assert torch.all(idx[:, 1:] > idx[:, :-1])          # sorted, distinct
    counts = torch.bincount(idx.reshape(-1), minlength=t).numpy()
    assert stats.chisquare(counts, np.full(t, b * keep / t)).pvalue > 1e-3


# --------------------------------------------------------------- config
def test_not_ported_no_longer_lists_the_five_options():
    cfg = {"train_batch_size": 2,
           "progressive_layer_drop": {"enabled": True, "theta": 0.4,
                                      "gamma": 0.01},
           "data_efficiency": {"data_routing": {"random_ltd": {
               "enabled": True, "min_value": 8}}},
           "curriculum_learning": {"enabled": True,
                                   **CURRICULA["fixed_linear"]},
           "tensorboard": {"enabled": True}, "wandb": {"enabled": True},
           "csv_monitor": {"enabled": True, "output_path": "/x"},
           "jsonl_monitor": {"enabled": True}, "monitor_interval": 3,
           "flops_profiler": {"enabled": True, "profile_step": 5}}
    t, j = TConfig(cfg), JConfig(cfg, world_size=1)
    assert t.not_ported() == []
    assert TConfig({**cfg, "comms_logger": {"enabled": True}}).not_ported() \
        == ["comms_logger"]
    assert (t.pld_config.theta, t.pld_config.gamma) == \
        (j.pld_config.theta, j.pld_config.gamma)
    assert t.random_ltd_params == j.random_ltd_params
    assert t.curriculum_params_legacy == j.curriculum_params_legacy
    assert t.monitor_interval == j.monitor_interval == 3
    assert t.monitor_config.enabled and \
        t.monitor_config.csv_monitor.output_path == "/x"
    assert t.flops_profiler_config.profile_step == \
        j.flops_profiler_config.profile_step == 5


# -------------------------------------------------------------- engines
def _ecfg(**extra):
    cfg = {"train_batch_size": MICRO * GAS, "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "steps_per_print": 0, "seed": 5}
    cfg.update(extra)
    return cfg


# random-LTD and the curriculum on one engine pair: the batches cut to
# 16 of their 32 tokens (a schedule whose steps 1-3 stay at 16: one
# compile on the reference's side), LTD keeping 12 of them; the csv and
# JSONL monitors on. The schedules' movement is held above and by the
# step-FLOPs test.
LTD_CURRICULUM = {
    "data_efficiency": {"data_routing": {"random_ltd": {
        "enabled": True, "random_ltd_schedule": {"min_value": 12,
                                                 "max_value": 12}}}},
    "curriculum_learning": {
        "enabled": True, "schedule_type": "fixed_linear",
        "schedule_config": {"min_difficulty": 16, "max_difficulty": T,
                            "total_curriculum_step": 100,
                            "difficulty_step": 16}},
    "monitor_interval": 1}
ENGINE_CASES = {
    "random_ltd_curriculum": LTD_CURRICULUM,
    "pld": {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                       "gamma": 0.5}},
}
# the port's host-optimizer path on the same option, held against the
# reference's device-state rows of its case (fp32: the host Adam and the
# device Adam apply the same update)
OFFLOAD = {"zero_optimization": {"stage": 2,
                                 "offload_optimizer": {"device": "cpu"}}}
ENGINE_RUNS = list(ENGINE_CASES) + ["random_ltd_curriculum_offload"]


def _monitors(root):
    return {"csv_monitor": {"enabled": True, "output_path": str(root)},
            "jsonl_monitor": {"enabled": True, "output_path": str(root)}}


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """Per case: the reference's engine and the port's (3 layers), one
    init, 3 steps on the same batches with the draws fixed; rows of (loss,
    grad norm), and the monitors' directories. Every engine is destroyed
    at teardown."""
    root = tmp_path_factory.mktemp("de")
    out, engines = {"root": root}, []

    def steps(eng):
        engines.append(eng)
        return [(float(eng.train_batch_from_stacked(_batch(10 + i, gas=GAS))),
                 eng.get_global_grad_norm()) for i in range(3)]

    def port(cfg, init):
        return deepspeed_tpu_torch.initialize(
            model=GPT2Model(GPT2Config(**_cfg(3)), compute_dtype=torch.float32),
            config=cfg, device="cpu",
            params=gpt2_params_from_numpy(init, "cpu"))[0]

    try:
        for name, extra in ENGINE_CASES.items():
            with pytest.MonkeyPatch.context() as mp:
                _patch_ltd(mp)
                _patch_pld(mp)
                mon = "monitor_interval" in extra
                cfg = _ecfg(**extra, **(_monitors(root / "jax") if mon else {}))
                jeng, *_ = deepspeed_tpu.initialize(
                    model=JGPT2Model(JGPT2Config(**_cfg(3)),
                                     compute_dtype=jnp.float32),
                    config=JConfig(cfg, world_size=1),
                    topology=MeshTopology(ParallelDims(),
                                          devices=jax.devices()[:1]))
                init = jax.device_get(jeng.state.params)
                run = {"jax": steps(jeng), "jax_engine": jeng}
                cfg = _ecfg(**extra, **(_monitors(root / "port") if mon else {}))
                run["port_engine"] = port(cfg, init)
                run["port"] = steps(run["port_engine"])
                out[name] = run
                if name == "random_ltd_curriculum":
                    teng = port(_ecfg(**extra, **OFFLOAD), init)
                    out[name + "_offload"] = {
                        "jax": run["jax"], "jax_engine": jeng,
                        "port": steps(teng), "port_engine": teng}
        yield out
    finally:
        for eng in engines:
            eng.destroy()


@pytest.mark.parametrize("name", ENGINE_RUNS)
def test_engine_steps_match_reference(engine_runs, name):
    run = engine_runs[name]
    for (jl, jn), (tl, tn) in zip(run["jax"], run["port"]):
        assert abs(tl - jl) <= ENGINE_TOL * abs(jl), (run["jax"], run["port"])
        assert abs(tn - jn) <= ENGINE_TOL * abs(jn), (run["jax"], run["port"])
    jeng, teng = run["jax_engine"], run["port_engine"]
    assert teng.global_steps == jeng.global_steps == 3
    if name == "pld":
        assert teng.progressive_layer_drop.get_theta() == \
            jeng.progressive_layer_drop.get_theta() < 1.0
        return
    assert teng.random_ltd_scheduler.state_dict() == \
        jeng.random_ltd_scheduler.state_dict()
    assert teng._use_random_ltd and jeng._use_random_ltd
    assert teng.curriculum_scheduler.get_current_difficulty() == \
        jeng.curriculum_scheduler.get_current_difficulty() == 16
    if name.endswith("offload"):
        assert teng._host_opt is not None and teng._host_opt.step_count == 3
        return
    d = {pkg: engine_runs["root"] / pkg for pkg in ("jax", "port")}
    job = "DeepSpeedJobName"
    csv = {pkg: {f: np.loadtxt(d[pkg] / job / f, delimiter=",", skiprows=1)
                 for f in sorted(os.listdir(d[pkg] / job))} for pkg in d}
    assert sorted(csv["port"]) == sorted(csv["jax"]) == \
        ["Train_Samples_lr.csv", "Train_Samples_train_loss.csv"]
    jsonl = {pkg: [(r["tag"], r["step"], r["value"]) for r in
                   read_jsonl(str(d[pkg] / f"{job}.jsonl"))] for pkg in d}
    assert [r[:2] for r in jsonl["port"]] == [r[:2] for r in jsonl["jax"]]
    assert len(jsonl["port"]) == 6
    for got, want in zip(jsonl["port"], jsonl["jax"]):
        assert abs(got[2] - want[2]) <= ENGINE_TOL * abs(want[2]), (got, want)
    for f, want in csv["jax"].items():
        got = csv["port"][f]
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        assert np.all(np.abs(got[:, 1] - want[:, 1])
                      <= ENGINE_TOL * np.abs(want[:, 1])), f


def test_step_flops_follow_each_steps_length_and_kept_tokens():
    """The port's repair of the reference's first-step count: under the
    curriculum and random-LTD, each step's FLOPs are the model's count at
    that step's (cut) length and kept tokens, and the fence's rate gauge
    reads the window's mean step."""
    cfg = _ecfg(**{
        "curriculum_learning": {
            "enabled": True, "schedule_type": "fixed_linear",
            "schedule_config": {"min_difficulty": 8, "max_difficulty": T,
                                "total_curriculum_step": 3,
                                "difficulty_step": 8}},
        "data_efficiency": {"data_routing": {"random_ltd": {
            "enabled": True, "random_ltd_schedule": {
                "min_value": 8, "max_value": T,
                "schedule_config": {"seq_per_step": 8,
                                    "total_layer_tokens_steps": 4}}}}},
        "telemetry": {"sync_interval": 4}})
    model = GPT2Model(GPT2Config(**_cfg(3)), compute_dtype=torch.float32)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                             device="cpu")
    want = []
    for i in range(5):
        seq = eng.curriculum_scheduler.get_difficulty(eng.global_steps + 1)
        keep = eng.random_ltd_scheduler.update_seq(eng.global_steps)
        eng.train_batch_from_stacked(_batch(20 + i, gas=GAS))
        ltd = keep if keep < seq else None
        want.append(model.flops_per_token(seq, ltd_keep=ltd)
                    * GAS * MICRO * seq)
        assert eng._telemetry_flops == want[-1], (i, seq, keep)
    assert len(set(want)) == 5                  # every step counted anew
    g = eng.telemetry.snapshot()["gauges"]
    # the fence at step 4 reads the window of steps 2-4
    mean = g["train/model_tflops"] * 1e12 * g["train/device_step_time_ms"] / 1e3
    assert abs(mean - np.mean(want[1:4])) <= 1e-9 * mean, (mean, want)
    eng.destroy()
