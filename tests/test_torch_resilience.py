"""Training resilience in the port (runtime/sentinel.py, the engine's
rewind-and-skip recovery, the SDC audit and the step-replay probe, the
preemption hook, the training seams of testing/fault_injection.py)
against the JAX package's, on the CPU, in fp32.

* The sentinel: the same scalar series through both packages'
  ``TrainingSentinel`` classify every step identically (class, step,
  value, z-score, detail: both are the same float64 arithmetic).
* ``sdc_audit``: the same synthetic checksum map names the same suspects
  on both sides. On one device every leaf has one copy, so an engine's
  audit compares no group and reads ok on both sides, a flipped bit too.
* One chaos run on each side (module-scoped), as the JAX package's
  ``TestChaosPin`` runs it: the JAX package's ``SimpleModel`` and its
  torch counterpart below (parameters carried across as numpy arrays),
  one seeded dataset with a ``"nan"`` and a ``"huge"`` batch, the newest
  tag corrupted before the second rewind. Held: the ``rewind_log``s equal
  record for record; losses within 1e-5 relative and the final
  parameters within 1e-5 (the same f32 arithmetic through two
  libraries); the port's run bit-identical to its own clean run with the
  same skips (the same arithmetic on the same values).
* A tiny GPT-2 on the port under the chip phase's ``flip_param_bit``
  schedule, bit-identical to its own clean run with the same skips; the
  replay probe clean and perturbed; preemption and resume bit-identical.
* The typed errors, the guard's default, one device-to-host copy per
  sentinel check.

The module's torch ops run in one intra-op thread.
"""

import math
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "unit"))
from simple_model import SimpleModel, random_batch, random_dataset  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu.runtime.sentinel as jsen  # noqa: E402
import deepspeed_tpu.testing.fault_injection as jfi  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
import deepspeed_tpu_torch.ops.adam as tadam  # noqa: E402
import deepspeed_tpu_torch.runtime.engine as tengine  # noqa: E402
import deepspeed_tpu_torch.runtime.sentinel as tsen  # noqa: E402
import deepspeed_tpu_torch.testing.fault_injection as tfi  # noqa: E402
from deepspeed_tpu.parallel.topology import MeshTopology, ParallelDims  # noqa: E402
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig  # noqa: E402
from deepspeed_tpu_torch import telemetry  # noqa: E402
from deepspeed_tpu_torch.elasticity import PREEMPTION_EXIT_CODE  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model  # noqa: E402
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader  # noqa: E402
from deepspeed_tpu_torch.runtime.sentinel import (  # noqa: E402
    AnomalyClass, RewindBudgetExceededError, TrainingAnomalyError)
from deepspeed_tpu_torch.runtime.zero.offload import param_names  # noqa: E402
from deepspeed_tpu_torch.utils.tree import tree_leaves  # noqa: E402

HIDDEN = 8
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """torch's intra-op team cut to one thread for the module (its ops are
    too small to gain from more; on a loaded host each op's thread barrier
    cost more than the op), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TorchSimpleModel:
    """The JAX package's ``SimpleModel`` (tests/unit/simple_model.py): an
    MLP of ``nlayers`` tanh layers and a linear head, mean-squared error."""

    def __init__(self, hidden_dim: int = HIDDEN, nlayers: int = 2):
        self.hidden_dim, self.nlayers = hidden_dim, nlayers

    def apply(self, params, batch, *, rngs=None, train=False):
        h, y = batch["x"], batch["y"]
        for i in range(self.nlayers):
            h = torch.tanh(h @ params["layers"]["w"][i].to(h.dtype)
                           + params["layers"]["b"][i].to(h.dtype))
        pred = h @ params["head"].to(h.dtype)
        loss = torch.mean(torch.square(pred[..., 0].float() - y.float()))
        return loss, {"loss": loss}


def _cfg(resilience=None, telemetry_cfg=None, bf16=False, seed=0):
    cfg = {"train_batch_size": 8,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "steps_per_print": 0, "seed": seed}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    if resilience:
        cfg["resilience"] = resilience
    if telemetry_cfg:
        cfg["telemetry"] = telemetry_cfg
    return cfg


def _jax_params(seed=0):
    p = SimpleModel(hidden_dim=HIDDEN).init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, jax.device_get(p))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def t_engine(dataset=None, params=None, **kw):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TorchSimpleModel(), config=_cfg(**kw), device="cpu",
        params=_to_torch(params if params is not None else _jax_params()))
    if dataset is not None:
        # in-order stream: batch j feeds step j+1
        eng.training_dataloader = eng.deepspeed_io(dataset, shuffle=False)
    return eng


def j_engine(dataset=None, **kw):
    eng, *_ = deepspeed_tpu.initialize(
        model=SimpleModel(hidden_dim=HIDDEN), config=JConfig(_cfg(**kw),
                                                              world_size=1),
        topology=MeshTopology(ParallelDims(), devices=jax.devices()[:1]))
    if dataset is not None:
        eng.training_dataloader = eng.deepspeed_io(dataset, shuffle=False)
    return eng


def t_state(eng):
    """Params and moments of a port engine as numpy, by leaf order."""
    st = eng.state
    leaves = tree_leaves(st.params) + tree_leaves(st.opt_state.exp_avg) \
        + tree_leaves(st.opt_state.exp_avg_sq)
    return [x.detach().cpu().numpy().copy() for x in leaves]


def states_equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def run_clean_with_skips(engine, total_steps, skips):
    """Drive a fault-free engine, discarding ``skips[global_steps]``
    batches before the matching step (the uninterrupted run that skipped
    the window). Returns the losses."""
    skips, losses = dict(skips), []
    while engine.global_steps < total_steps:
        it = engine._ensure_train_iter()
        for _ in range(skips.pop(engine.global_steps, 0)):
            next(it)
        losses.append(float(engine.train_batch()))
    return losses


# ---------------------------------------------------------------- sentinel
def _series(name):
    """(sentinel keywords, [(loss, grad_norm, overflow)]) of one case."""
    warm = [(1.0 + 0.02 * (i % 3), 0.5, False) for i in range(8)]
    if name == "clean":
        return {}, [(1.0 - 0.01 * i, 0.5 + 0.01 * i, False) for i in range(20)]
    if name == "spike":
        return {}, warm + [(100.0, 0.5, False), (100.0, 0.5, False),
                           (1.0, 0.5, False)]
    if name == "grad_norm_spike":
        return {}, [(1.0, 0.5 + 0.01 * (i % 3), False) for i in range(8)] \
            + [(1.0, 500.0, False)]
    if name == "nonfinite":
        return {"min_history": 8}, [(float("nan"), 0.5, False),
                                    (1.0, float("inf"), False),
                                    (float("-inf"), 0.5, False)]
    if name == "overflow_fp16":
        return {"fp16": True}, [(1.0, 0.5, True), (1.0, 0.5, False)]
    if name == "overflow_guard":
        return {"fp16": False}, [(1.0, 0.5, True), (1.0, 0.5, False)]
    if name == "divergence":
        return {"divergence_patience": 3}, warm + [
            (100.0 + k, 0.5, False) for k in range(4)] + [(1.0, 0.5, False)]
    if name == "min_history_warmup":
        return {"min_history": 6}, [(1.0, 0.5, False), (1e6, 0.5, False),
                                    (1.0, 0.5, False)]
    if name == "window_rolls":
        return {"window": 4, "min_history": 3}, [
            (1.0 + 0.5 * i, 0.1, False) for i in range(12)] + [(40.0, 0.1, False)]
    raise KeyError(name)


SERIES = ("clean", "spike", "grad_norm_spike", "nonfinite", "overflow_fp16",
          "overflow_guard", "divergence", "min_history_warmup", "window_rolls")


def _classify(mod, name):
    kw, series = _series(name)
    kw = {"window": 16, "min_history": 4, "spike_zscore": 8.0, **kw}
    s = mod.TrainingSentinel(**kw)
    out = []
    for step, (loss, norm, ovf) in enumerate(series):
        a = s.observe(step, loss, norm, ovf)
        out.append(None if a is None else (a.cls, a.step, repr(a.value),
                                           repr(a.zscore), a.detail))
    return out, dict(s.counts), list(s.loss_stats.values)


@pytest.mark.parametrize("name", SERIES)
def test_sentinel_classifies_as_jax(name):
    want, got = _classify(jsen, name), _classify(tsen, name)
    assert got == want
    classes = [r[0] for r in got[0] if r is not None]
    expect = {"clean": [], "spike": ["spike", "spike"],
              "grad_norm_spike": ["spike"],
              "nonfinite": ["nonfinite"] * 3, "overflow_fp16": ["overflow"],
              "overflow_guard": ["nonfinite"],
              "divergence": ["spike", "spike", "divergence", "divergence"],
              "min_history_warmup": [], "window_rolls": ["spike"]}[name]
    assert classes == expect


@pytest.mark.parametrize("case", ["one_bad", "two_bad_one_leaf",
                                  "one_device_many_leaves", "tie", "singles"])
def test_sdc_vote_names_the_same_suspects(case, monkeypatch):
    full = (None, None, None)
    groups = {
        "one_bad": {("a", (full,)): {0: 7, 1: 7, 2: 9, 3: 7}},
        "two_bad_one_leaf": {("a", (full,)): {0: 1, 1: 2, 2: 1, 3: 3}},
        "one_device_many_leaves": {
            ("a", (full,)): {0: 1, 1: 1, 2: 5},
            ("b", (full,)): {0: 4, 1: 4, 2: 6},
            ("c", (full,)): {0: 8, 1: 9, 2: 8}},
        "tie": {("a", (full,)): {0: 1, 1: 2}},
        "singles": {("a", (full,)): {0: 1}, ("b", (full,)): {0: 2}},
    }[case]
    results = []
    for mod in (jsen, tsen):
        monkeypatch.setattr(mod, "replica_checksums",
                            lambda tree, min_copies=1: groups)
        results.append(tuple(mod.sdc_audit(None)))
    assert results[1] == results[0]
    if case == "one_device_many_leaves":
        assert results[1] == (False, (2, 1), 3, 3)
    if case == "singles":
        assert results[1] == (True, (), 0, 0)


def test_one_device_audit_has_one_voter_on_both_sides(chaos):
    """One device holds one copy of every leaf: the audit compares no
    group and reads ok, even over a flipped bit (the JAX package on a
    one-device mesh reads the same)."""
    data = random_dataset(n=64, hidden_dim=HIDDEN, seed=29)
    t = t_engine(dataset=data)
    for _ in range(2):
        t.train_batch()
    res = tsen.sdc_audit({"params": t.state.params,
                          "opt_state": t.state.opt_state})
    assert tuple(res) == (True, (), 0, 0)
    tfi.flip_param_bit(t, device_index=0, leaf_index=0, byte=5, bit=2)
    assert tuple(tsen.sdc_audit(t.state.params)) == (True, (), 0, 0)
    with pytest.raises(ValueError, match="one device"):
        tfi.flip_param_bit(t, device_index=3)
    # the JAX package's flip lands in a stand-in holding the chaos
    # engine's state, so the engine itself stays as the run left it
    stand_in = type("E", (), {"state": chaos["jax"][0].state})()
    jfi.flip_param_bit(stand_in, device_index=0, leaf_index=0, byte=5, bit=2)
    assert tuple(jsen.sdc_audit(stand_in.state.params)) == (True, (), 0, 0)


def test_the_audit_hashes_no_group_of_one_copy(monkeypatch):
    """Leaves are grouped before hashing: on one device the audit hashes
    nothing, while ``replica_checksums`` still keys every tensor leaf."""
    t = t_engine()
    tree = {"params": t.state.params, "opt_state": t.state.opt_state}
    calls, real = [], tsen._crc
    monkeypatch.setattr(tsen, "_crc",
                        lambda leaf, value=0: calls.append(1) or real(leaf,
                                                                     value))
    assert tuple(tsen.sdc_audit(tree)) == (True, (), 0, 0) and calls == []
    groups = tsen.replica_checksums(tree)
    n = sum(isinstance(x, torch.Tensor) for _, x in tsen._tree_items(tree))
    assert len(groups) == len(calls) == n > 0
    assert all(len(per_dev) == 1 for per_dev in groups.values())


def test_flip_param_bit_flips_one_bit_of_the_named_leaf():
    t = t_engine()
    before = [x.clone() for x in tree_leaves(t.state.params)]
    assert tfi.flip_param_bit(t, leaf_index=1, byte=7, bit=6) == 1
    after = tree_leaves(t.state.params)
    for i, (a, b) in enumerate(zip(before, after)):
        xa = a.view(-1).view(torch.uint8)
        xb = b.view(-1).view(torch.uint8)
        diff = (xa ^ xb).nonzero().flatten().tolist()
        assert diff == ([7] if i == 1 else []), (i, diff)
        if i == 1:
            assert int(xa[7] ^ xb[7]) == 1 << 6


def test_corrupt_file_refuses_vacuous_truncation(tmp_path):
    small = tmp_path / "latest"
    small.write_text("t1")
    with pytest.raises(ValueError, match="no-op"):
        tfi.corrupt_file(str(small), keep_bytes=64)


def test_poisoned_dataset_matches_jax():
    data = random_dataset(n=16, hidden_dim=HIDDEN, seed=2)
    poison = {3: "nan", 5: "huge"}
    jp, tp = jfi.PoisonedDataset(data, poison), tfi.PoisonedDataset(data, poison)
    for i in range(len(data)):
        for k in ("x", "y"):
            np.testing.assert_array_equal(np.asarray(jp[i][k]), tp[i][k])
    ids = {"input_ids": np.arange(4, dtype=np.int32)}
    assert tfi.poison_sample(ids, "nan")["input_ids"] is ids["input_ids"]
    with pytest.raises(ValueError, match="poison mode"):
        tfi.poison_sample(data[0], "zero")


# ------------------------------------------------------------- chaos pin
CHAOS_RES = {"enabled": True, "checkpoint_interval": 4, "check_interval": 1,
             "min_history": 6, "spike_zscore": 50.0}
CHAOS_POISON = {16: "nan", 112: "huge"}     # batch 2 -> step 3; batch 14
CHAOS_STEPS = 16


def _chaos(make, root, seed_data):
    """The JAX package's TestChaosPin run on one engine (``make``); returns
    (engine, losses)."""
    ckpt = str(root / "ck")
    eng = make(dataset=jfi.PoisonedDataset(seed_data, CHAOS_POISON)
               if make is j_engine else
               tfi.PoisonedDataset(seed_data, CHAOS_POISON),
               resilience={**CHAOS_RES, "checkpoint_dir": ckpt})
    losses, corrupted = [], False
    while eng.global_steps < CHAOS_STEPS:
        tag8 = os.path.join(ckpt, "global_step8", "state.npz")
        if eng.global_steps >= 9 and not corrupted and os.path.exists(tag8):
            tfi.corrupt_file(tag8, keep_bytes=100)   # bit rot after publish
            corrupted = True
        losses.append(float(np.asarray(eng.train_batch())))
    assert corrupted
    return eng, losses


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    root = tmp_path_factory.mktemp("chaos")
    data = random_dataset(n=512, hidden_dim=HIDDEN, seed=3)
    telemetry.reset_registry()
    jeng, jlosses = _chaos(j_engine, root / "jax", data)
    try:
        teng, tlosses = _chaos(t_engine, root / "port", data)
        reg = telemetry.get_registry()
        counters = {n: reg.counter(f"resilience/{n}").value for n in (
            "rewinds", "skipped_batches", "anomalies_nonfinite",
            "anomalies_spike")}
        clean = t_engine(dataset=data)
        clean_losses = run_clean_with_skips(
            clean, CHAOS_STEPS,
            {r["rewound_to"]: r["skipped_batches"] for r in teng.rewind_log})
        yield {"jax": (jeng, jlosses), "port": (teng, tlosses),
               "clean": (clean, clean_losses), "counters": counters}
    finally:
        jeng.destroy()


def _log_fields(log):
    return [{k: (os.path.basename(v) if k == "checkpoint" else v)
             for k, v in r.items() if k != "recovery_ms"} for r in log]


def test_chaos_rewind_logs_equal_jax(chaos):
    jlog = _log_fields(chaos["jax"][0].rewind_log)
    tlog = _log_fields(chaos["port"][0].rewind_log)
    assert tlog == jlog
    assert [r["class"] for r in tlog] == [AnomalyClass.NONFINITE,
                                          AnomalyClass.SPIKE]
    assert tlog[0] == dict(tlog[0], anomaly_step=3, rewound_to=0,
                           skipped_batches=4)
    # the corrupt global_step8 tag was skipped by the walk-back
    assert tlog[1] == dict(tlog[1], anomaly_step=11, rewound_to=4,
                           skipped_batches=8, checkpoint="global_step4")


def test_chaos_losses_and_params_match_jax(chaos):
    jl, tl = chaos["jax"][1], chaos["port"][1]
    assert len(tl) == len(jl)
    for a, b in zip(jl, tl):
        if math.isnan(a):
            assert math.isnan(b)
        else:
            assert abs(b - a) <= LOSS_RTOL * abs(a), (a, b)
    jp = jax.tree_util.tree_leaves(jax.device_get(chaos["jax"][0].state.params))
    tp = tree_leaves(chaos["port"][0].state.params)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=PARAM_ATOL)


def test_chaos_port_run_is_bit_identical_to_its_clean_run(chaos):
    teng, clean = chaos["port"][0], chaos["clean"][0]
    assert states_equal(t_state(teng), t_state(clean))
    assert teng.state.global_step == clean.state.global_step
    assert chaos["counters"] == {"rewinds": 2, "skipped_batches": 12,
                                 "anomalies_nonfinite": 1,
                                 "anomalies_spike": 1}


# -------------------------------------------------- tiny GPT-2, bit flips
GPT_CFG = dict(vocab_size=512, max_seq_len=32, num_layers=2, hidden_size=64,
               num_heads=2)
GPT_GAS, GPT_MICRO, GPT_T = 2, 2, 32
FLIP_AFTER = (6, 13)       # flip a master's top exponent bit after these steps
FLIP_INTERVAL = 4          # checkpoint_interval
FLIP_END = 11


def _lm_samples(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start, step = rng.randint(0, 512), rng.randint(1, 8)
        ids = ((start + step * np.arange(GPT_T + 1)) % 512).astype(np.int32)
        out.append({"input_ids": ids[:-1], "labels": ids[1:]})
    return out


def _gpt_engine(data, **res):
    cfg = {"train_batch_size": GPT_MICRO * GPT_GAS,
           "gradient_accumulation_steps": GPT_GAS,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "steps_per_print": 0, "seed": 3}
    if res:
        cfg["resilience"] = res
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(**GPT_CFG), compute_dtype=torch.float32,
                        attn_impl="flash"),
        config=cfg, training_data=data, device="cpu")
    return eng


def _flip_top_exponent(eng, name="['blocks']['qkv_w']", element=5):
    """Flip bit 30 (the exponent's top bit) of one f32 master element."""
    names = list(param_names(eng.state.params))
    return tfi.flip_param_bit(eng, leaf_index=names.index(name),
                              byte=4 * element + 3, bit=6)


def test_tiny_gpt2_flip_schedule_heals_bit_identical(tmp_path):
    data = _lm_samples(512)
    ckpt = str(tmp_path / "ck")
    telemetry.reset_registry()
    eng = _gpt_engine(data, enabled=True, checkpoint_dir=ckpt,
                      checkpoint_interval=FLIP_INTERVAL, check_interval=1,
                      spike_zscore=50.0)
    flips = list(FLIP_AFTER)
    while eng.global_steps < FLIP_END or flips:
        if flips and eng.global_steps == flips[0]:
            if len(flips) == 1:       # corrupt the newest tag first
                newest = open(os.path.join(ckpt, "latest")).read().strip()
                tfi.corrupt_file(os.path.join(ckpt, newest, "state.npz"))
            _flip_top_exponent(eng)
            flips.pop(0)
        eng.train_batch()
    log = eng.rewind_log
    assert [(r["class"], r["anomaly_step"], r["rewound_to"],
             r["skipped_batches"], os.path.basename(r["checkpoint"]))
            for r in log] == [
        (AnomalyClass.NONFINITE, 7, 4, GPT_GAS * (3 + 1), "global_step4"),
        (AnomalyClass.NONFINITE, 14, 8, GPT_GAS * (6 + 1), "global_step8")]
    reg = telemetry.get_registry()
    assert reg.counter("resilience/rewinds").value == 2
    assert reg.counter("resilience/skipped_batches").value == GPT_GAS * 11
    assert reg.counter("resilience/anomalies_nonfinite").value == 2
    clean = _gpt_engine(data)
    run_clean_with_skips(clean, FLIP_END,
                         {r["rewound_to"]: r["skipped_batches"] for r in log})
    assert states_equal(t_state(eng), t_state(clean))


# ------------------------------------------------------- step-replay probe
def test_step_replay_probe_clean_perturbed_and_state_kept():
    data = random_dataset(n=64, hidden_dim=HIDDEN, seed=37)
    eng = t_engine(dataset=data)
    eng.train_batch()
    batch = eng._to_device({k: v[None] for k, v in random_batch(
        batch_size=8, hidden_dim=HIDDEN, seed=1).items()})
    live = t_state(eng)
    step = lambda st: eng._train_step(st, batch, 1e-2)  # noqa: E731
    ok, detail = tsen.step_replay_probe(step, eng.state)
    assert ok, detail
    calls = [0]

    def flaky(st):                    # a flaky ALU on the second replay
        calls[0] += 1
        out, m = step(st)
        if calls[0] == 2:
            tfi.flip_param_bit(type("E", (), {"state": out})(), byte=2)
        return out, m

    ok, detail = tsen.step_replay_probe(flaky, eng.state)
    assert not ok and "differ" in detail
    assert states_equal(live, t_state(eng)), "the probe touched the live state"


def test_engine_replay_probe_counts_match_jax():
    data = random_dataset(n=64, hidden_dim=HIDDEN, seed=41)
    res = {"enabled": True, "check_interval": 1, "step_replay_interval": 2,
           "min_history": 6, "spike_zscore": 50.0}
    counts = []
    for make, tele in ((j_engine, None), (t_engine, telemetry)):
        from deepspeed_tpu import telemetry as jtele
        reg_mod = tele or jtele
        reg_mod.reset_registry()
        eng = make(dataset=data, resilience=res,
                   telemetry_cfg={"enabled": True})
        for _ in range(4):
            eng.train_batch()
        reg = reg_mod.get_registry()
        counts.append((reg.counter("resilience/step_replays").value,
                       reg.counter("resilience/step_replay_mismatches").value,
                       eng.rewind_log))
        eng.destroy()
    assert counts[1] == counts[0] == (2, 0, [])


def test_perturbed_probe_rewinds_skips_nothing_and_ends_bit_identical(tmp_path):
    data = random_dataset(n=128, hidden_dim=HIDDEN, seed=43)
    telemetry.reset_registry()
    eng = t_engine(dataset=data, resilience={
        "enabled": True, "checkpoint_dir": str(tmp_path / "ck"),
        "check_interval": 1, "step_replay_interval": 2})
    real, calls = eng._train_step, [0]

    def perturbed(state, *a, **k):
        out, m = real(state, *a, **k)
        calls[0] += 1
        if calls[0] == 3:            # step 2, then the probe's two replays
            tfi.flip_param_bit(type("E", (), {"state": out})(), byte=1)
        return out, m

    eng.train_batch()                    # step 1
    eng._train_step = perturbed
    eng.train_batch()                    # step 2 + the probe's two replays
    assert calls[0] == 3
    eng._train_step = real
    assert eng.rewind_log and eng.rewind_log[0] == dict(
        eng.rewind_log[0], **{"class": AnomalyClass.REPLAY}, anomaly_step=2,
        rewound_to=0, skipped_batches=0)
    while eng.global_steps < 6:
        eng.train_batch()
    reg = telemetry.get_registry()
    assert reg.counter("resilience/step_replay_mismatches").value == 1
    assert reg.counter("resilience/step_replays").value == 4   # 2, 2, 4, 6
    assert reg.counter("resilience/anomalies_replay").value == 0  # not the
    # sentinel's class: the probe's own counter records it
    clean = t_engine(dataset=data)
    run_clean_with_skips(clean, 6, {})
    assert states_equal(t_state(eng), t_state(clean))


def test_host_optimizer_path_rewinds_and_skips_the_probe(tmp_path):
    """Under ``offload_optimizer`` the sentinel reads the host step's loss,
    norm and flag, a NaN batch rewinds as on the device path, and the
    replay probe is skipped (as the reference skips it)."""
    data = random_dataset(n=128, hidden_dim=HIDDEN, seed=47)
    zero = {"zero_optimization": {"stage": 2,
                                  "offload_optimizer": {"device": "cpu"}}}

    def host_engine(dataset, res=None):
        cfg = {**_cfg(resilience=res), **zero}
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=TorchSimpleModel(), config=cfg, device="cpu",
            params=_to_torch(_jax_params()))
        eng.training_dataloader = eng.deepspeed_io(dataset, shuffle=False)
        return eng

    telemetry.reset_registry()
    eng = host_engine(tfi.PoisonedDataset(data, {16: "nan"}), {
        "enabled": True, "checkpoint_dir": str(tmp_path / "ck"),
        "checkpoint_interval": 2, "check_interval": 1,
        "step_replay_interval": 1})
    assert eng._host_opt is not None
    while eng.global_steps < 6:
        eng.train_batch()
    assert [(r["class"], r["anomaly_step"], r["rewound_to"],
             r["skipped_batches"]) for r in eng.rewind_log] == [
        (AnomalyClass.NONFINITE, 3, 2, 2)]
    assert telemetry.get_registry().counter(
        "resilience/step_replays").value == 0
    clean = host_engine(data)
    run_clean_with_skips(clean, 6, {2: 2})
    for a, b in zip(tree_leaves(eng.state.params),
                    tree_leaves(clean.state.params)):
        assert torch.equal(a, b)
    for name in eng._host_opt.master:
        assert torch.equal(eng._host_opt.master[name],
                           clean._host_opt.master[name])


# ---------------------------------------------------------------- errors
def test_anomaly_without_recovery_path_raises_typed():
    data = random_dataset(n=64, hidden_dim=HIDDEN, seed=23)
    eng = t_engine(dataset=tfi.PoisonedDataset(data, {16: "nan"}),
                   resilience={"enabled": True, "check_interval": 1})
    with pytest.raises(TrainingAnomalyError) as ei:
        for _ in range(6):
            eng.train_batch()
    assert (ei.value.anomaly.cls, ei.value.anomaly.step) == (
        AnomalyClass.NONFINITE, 3)


def test_caller_supplied_iterator_raises_not_silently_desyncs(tmp_path):
    data = random_dataset(n=128, hidden_dim=HIDDEN, seed=23)
    eng = t_engine(dataset=data, resilience={
        "enabled": True, "check_interval": 1,
        "checkpoint_dir": str(tmp_path / "ck"), "checkpoint_interval": 2})
    it = iter(RepeatingLoader(eng.deepspeed_io(
        tfi.PoisonedDataset(data, {16: "nan"}), shuffle=False)))
    with pytest.raises(TrainingAnomalyError):
        for _ in range(6):
            eng.train_batch(data_iter=it)
    assert eng.rewind_log == []


def test_stateless_checkpoint_raises_instead_of_desyncing(tmp_path):
    data = random_dataset(n=128, hidden_dim=HIDDEN, seed=43)
    eng = t_engine(dataset=tfi.PoisonedDataset(data, {24: "nan"}),
                   resilience={"enabled": True, "check_interval": 1,
                               "checkpoint_dir": str(tmp_path / "ck"),
                               "checkpoint_interval": 0})
    eng.train_batch()          # the baseline tag (with loader state)
    eng.train_batch()
    dl, eng.training_dataloader = eng.training_dataloader, None
    eng.save_checkpoint(str(tmp_path / "ck"), tag="stateless")
    eng.training_dataloader = dl
    with pytest.raises(TrainingAnomalyError, match="no dataloader state"):
        for _ in range(4):
            eng.train_batch()
    assert eng.rewind_log == []


def test_rewind_budget_prevents_livelock(tmp_path):
    data = random_dataset(n=128, hidden_dim=HIDDEN, seed=19)
    eng = t_engine(
        dataset=tfi.PoisonedDataset(data, {i: "nan" for i in range(0, 128, 8)}),
        resilience={"enabled": True, "checkpoint_dir": str(tmp_path / "ck"),
                    "checkpoint_interval": 4, "check_interval": 1,
                    "max_rewinds": 3, "skip_width_max": 1,
                    "skip_width_base": 1, "skip_width_factor": 1})
    with pytest.raises(RewindBudgetExceededError, match="budget"):
        while eng.global_steps < 20:
            eng.train_batch()
    assert len(eng.rewind_log) == 3


def test_guard_defaults_follow_enabled():
    assert t_engine(resilience={"enabled": True})._check_finite_grads
    assert not t_engine()._check_finite_grads
    assert not t_engine(resilience={
        "enabled": True, "check_finite_grads": False})._check_finite_grads
    assert t_engine(resilience={"check_finite_grads": True})._check_finite_grads


@pytest.mark.parametrize("guarded", [True, False])
def test_nan_grad_guard_skips_and_counts(guarded):
    eng = t_engine(bf16=True, resilience={"check_finite_grads": guarded})
    good = random_batch(batch_size=8, hidden_dim=HIDDEN, seed=0)
    eng.train_batch_from_stacked({k: v[None] for k, v in good.items()})
    before = t_state(eng)
    eng.train_batch_from_stacked({k: np.full_like(v, np.nan)[None]
                                  for k, v in good.items()})
    finite = all(np.isfinite(x).all() for x in t_state(eng))
    if guarded:
        assert states_equal(before, t_state(eng))
        assert (eng.state.global_step, eng.global_steps,
                eng.skipped_steps) == (1, 2, 1)
    else:
        assert not finite


# --------------------------------------------------- fences and transfers
_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__float__",
          "__int__", "__index__")


@pytest.mark.parametrize("guard", [False, True])
def test_one_device_to_host_copy_per_sentinel_check(guard, monkeypatch):
    """The sentinel reads every queued step in one copy at its fence and
    nothing between fences. The finite-grad guard, where armed, reads its
    flag every step (the skip decides the optimizer's host-side step
    count), where the JAX package skips inside its compiled step."""
    data = random_dataset(n=128, hidden_dim=HIDDEN, seed=5)
    eng = t_engine(dataset=data, resilience={
        "enabled": True, "check_interval": 4, "check_finite_grads": guard},
        telemetry_cfg={"enabled": False})
    eng.train_batch()
    reads = []
    for name in _READS:
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            (lambda n, f: lambda self, *a, **k: (
                                reads.append(n), f(self, *a, **k))[1])(name,
                                                                      real))
    per_step = []
    for _ in range(7):
        before = len(reads)
        eng.train_batch()
        per_step.append(reads[before:])
    monkeypatch.undo()
    # steps 2..8: the fences at 4 and 8 read every queued step in one copy
    flag = ["__bool__"] if guard else []
    assert per_step == [flag, flag, flag + ["tolist"], flag, flag, flag,
                        flag + ["tolist"]]


def test_spans_slo_and_flight_recorder_at_the_fence(tmp_path):
    data = random_dataset(n=128, hidden_dim=HIDDEN, seed=11)
    eng = t_engine(dataset=tfi.PoisonedDataset(data, {24: "nan"}),
                   resilience={"enabled": True, "check_interval": 1,
                               "checkpoint_dir": str(tmp_path / "ck")},
                   telemetry_cfg={"enabled": True, "spans": True,
                                  "flight_recorder": True})
    evaluated = []

    class Slo:
        def maybe_evaluate(self):
            evaluated.append(eng.global_steps)

    eng.set_slo(Slo())
    for _ in range(6):
        eng.train_batch()
    assert evaluated == [1, 2, 3, 4, 1, 2]   # the step-4 check rewound to 0
    names = [s.name for s in eng.tracer.spans]
    assert names.count("sentinel_check") == 6 and names.count("recovery") == 1
    dumps = eng.flight_recorder.dumps
    assert [d["reason"] for d in dumps] == ["training_anomaly"]
    assert dumps[0]["context"]["cls"] == AnomalyClass.NONFINITE
    eng.destroy()
    with pytest.raises(ValueError, match="sentinel armed"):
        t_engine().set_slo(Slo())


# ------------------------------------------------------------- preemption
def test_deferred_preemption_saves_at_the_step_boundary_and_resumes(tmp_path):
    data = _lm_samples(64, seed=4)
    ref = _gpt_engine(data)
    ref_losses = [float(ref.train_batch()) for _ in range(8)]

    eng = _gpt_engine(data)
    codes = []

    class Exit(Exception):
        pass

    def exit_fn(code):
        codes.append(code)
        raise Exit

    ckpt = str(tmp_path / "ck")
    h = eng.install_preemption_handler(ckpt, defer=True, exit_fn=exit_fn)
    try:
        for _ in range(5):
            eng.train_batch()
        h.trigger(reason="maintenance event")
        assert codes == [] and not os.path.exists(ckpt)
        with pytest.raises(Exit):
            eng.train_batch()           # the poll saves, then exits
    finally:
        h.uninstall()
    assert codes == [PREEMPTION_EXIT_CODE] and eng.global_steps == 5
    resumed = _gpt_engine(data)
    path, _ = resumed.load_checkpoint(ckpt)
    assert path.endswith("global_step5")
    assert [float(resumed.train_batch()) for _ in range(3)] == ref_losses[5:]
    assert states_equal(t_state(resumed), t_state(ref))


def test_immediate_preemption_writes_a_loadable_tag(tmp_path):
    eng = t_engine()
    codes = []
    h = eng.install_preemption_handler(str(tmp_path / "ck"),
                                       exit_fn=codes.append)
    try:
        h.trigger(reason="maintenance event")
    finally:
        h.uninstall()
    assert codes == [PREEMPTION_EXIT_CODE]
    assert (tmp_path / "ck" / "latest").exists()
    path, _ = t_engine().load_checkpoint(str(tmp_path / "ck"))
    assert path is not None


@pytest.mark.parametrize("where", ["after_the_pull", "optimizer_leaf_loop"])
def test_immediate_notice_inside_a_step_saves_at_its_boundary(
        where, tmp_path, monkeypatch):
    """With ``defer`` left False, a notice that lands inside a step (after
    train_batch pulled its batches, or in the optimizer's in-place leaf
    loop after its first leaf) saves at the end of that step: the tag
    holds the whole step, bit-identical to an uninterrupted run's state
    after it, and a run resumed from it goes on bit-identically."""
    data = _lm_samples(64, seed=4)
    ref = _gpt_engine(data)
    ref_losses = [float(ref.train_batch()) for _ in range(3)]
    ref_at3 = t_state(ref)
    ref_losses += [float(ref.train_batch()) for _ in range(2)]

    eng = _gpt_engine(data)
    codes, armed = [], [False]

    class Exit(Exception):
        pass

    def exit_fn(code):
        codes.append(code)
        raise Exit

    def fire():
        if armed[0]:
            armed[0] = False
            h.trigger(reason="signal SIGTERM")
            assert codes == [], "the notice saved inside the step"

    if where == "after_the_pull":
        real_stack = tengine._stack

        def stack(micro_batches):
            fire()
            return real_stack(micro_batches)

        monkeypatch.setattr(tengine, "_stack", stack)
    else:
        real_apply = tadam._apply

        def apply(params, fn, *trees):
            def leaf(*leaves):
                fn(*leaves)
                fire()
            real_apply(params, leaf, *trees)

        monkeypatch.setattr(tadam, "_apply", apply)
    ckpt = str(tmp_path / "ck")
    h = eng.install_preemption_handler(ckpt, exit_fn=exit_fn)
    try:
        for _ in range(2):
            eng.train_batch()
        armed[0] = True
        with pytest.raises(Exit):
            eng.train_batch()           # the notice lands in step 3
    finally:
        h.uninstall()
    assert not armed[0] and codes == [PREEMPTION_EXIT_CODE]
    assert eng.global_steps == 3
    monkeypatch.undo()
    resumed = _gpt_engine(data)
    path, _ = resumed.load_checkpoint(ckpt)
    assert path.endswith("global_step3")
    assert states_equal(t_state(resumed), ref_at3)
    assert [float(resumed.train_batch()) for _ in range(2)] == ref_losses[3:]
    assert states_equal(t_state(resumed), t_state(ref))


def test_notice_inside_step_saves_after_the_update(tmp_path, monkeypatch):
    """The forward / backward / step path: a notice that lands in
    ``step()``'s optimizer leaf loop saves once the update is whole."""
    batches = [random_batch(seed=s, hidden_dim=HIDDEN) for s in range(2)]

    def drive(eng, n):
        for b in batches[:n]:
            eng.backward(eng.forward(b))
            eng.step()

    ref = t_engine()
    drive(ref, 1)
    eng, codes = t_engine(), []
    h = eng.install_preemption_handler(str(tmp_path / "ck"),
                                       exit_fn=codes.append)
    real_apply = tadam._apply

    def apply(params, fn, *trees):
        def leaf(*leaves):
            fn(*leaves)
            if not h.preempted:
                h.trigger(reason="signal SIGTERM")
                assert codes == [], "the notice saved inside the update"
        real_apply(params, leaf, *trees)

    monkeypatch.setattr(tadam, "_apply", apply)
    try:
        drive(eng, 1)
    finally:
        h.uninstall()
    monkeypatch.undo()
    assert codes == [PREEMPTION_EXIT_CODE]
    resumed = t_engine()
    path, _ = resumed.load_checkpoint(str(tmp_path / "ck"))
    assert path.endswith("global_step1")
    assert states_equal(t_state(resumed), t_state(ref))


# -------------------------------------------------------------- fs seams
@pytest.mark.parametrize("fault", ["fail_writes", "truncate_write",
                                   "crash_on_replace", "fail_reads",
                                   "slow_writes"])
def test_fault_injector_seams_on_the_ports_fs(fault, tmp_path):
    eng = t_engine()
    ck = str(tmp_path / "ck")
    eng.save_checkpoint(ck, tag="good")
    sleeps = []
    with tfi.FaultInjector() as inj:
        inj.fast_retries()
        if fault == "fail_writes":
            inj.fail_writes(nth=1, count=99)
            with pytest.raises(OSError, match="injected"):
                eng.save_checkpoint(ck, tag="bad")
        elif fault == "truncate_write":
            inj.truncate_write(nth=1, keep_bytes=64)
            with pytest.raises(tfi.SimulatedCrash):
                eng.save_checkpoint(ck, tag="bad")
        elif fault == "crash_on_replace":
            inj.crash_on_replace(nth=1)
            with pytest.raises(tfi.SimulatedCrash):
                eng.save_checkpoint(ck, tag="bad")
        elif fault == "fail_reads":
            inj.fail_reads(nth=1, count=99)
            with pytest.raises(OSError, match="injected read"):
                tfi.fs.read_bytes_with_retry(os.path.join(ck, "latest"))
        else:
            inj.slow_writes(0.5, sleep_fn=sleeps.append)
            eng.save_checkpoint(ck, tag="slow")
            assert sleeps and set(sleeps) == {0.5}
    assert tfi.fs.write_bytes.__module__ == "deepspeed_tpu_torch.utils.fs"
    path, _ = t_engine().load_checkpoint(ck)
    want = "slow" if fault == "slow_writes" else "good"
    assert path.endswith(want)
