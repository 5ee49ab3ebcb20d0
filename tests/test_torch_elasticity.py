"""Elasticity in the port (deepspeed_tpu_torch/elasticity/, the fault
seams of deepspeed_tpu_torch/testing/) against the JAX package's, on the
CPU.

Every check runs the same host logic on both sides from the same inputs
and holds the results equal: the rolling restart budget, the capped
backoff (jitter drawn from two ``random.Random`` of one seed), the elastic
agent on a virtual clock over a scripted worker group (exit codes,
spawns, restarts, preemption restarts and every backoff sleep), the
preemption handler's final-checkpoint contract (immediate, deferred, with
a consensus vote, a failing checkpoint), and the elastic batch ladder on
the JAX package's configs. All exact: both sides are the same arithmetic
on Python floats and ints.
"""

import os
import random
import signal
import time

import pytest

import deepspeed_tpu.elasticity as jel
import deepspeed_tpu.elasticity.elastic_agent as jagent
import deepspeed_tpu.testing.fault_injection as jfi
import deepspeed_tpu_torch.elasticity as tel
import deepspeed_tpu_torch.elasticity.elastic_agent as tagent
import deepspeed_tpu_torch.testing.fault_injection as tfi
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig

SIDES = ((jel, jagent, jfi), (tel, tagent, tfi))


# --------------------------------------------------------- restart budget
def _budget_trace(agent_mod, fi):
    clock = fi.FakeClock()
    budget = agent_mod.RollingWindowBudget(2, window_s=100.0,
                                           time_fn=clock.time)
    out = [budget.record(), budget.record(), budget.exceeded(),
           budget.record(), budget.exceeded()]
    clock.advance(200.0)
    out += [budget.spent(), budget.record(), budget.exceeded()]
    forever = agent_mod.RollingWindowBudget(1, window_s=None,
                                            time_fn=clock.time)
    out += [forever.record(), forever.record(), forever.exceeded()]
    clock.advance(1e9)
    out += [forever.spent()]
    return out


def test_rolling_window_budget_matches_jax():
    want, got = (_budget_trace(a, f) for _, a, f in SIDES)
    assert got == want
    assert got[:8] == [1, 2, False, 3, True, 0, 1, False]


@pytest.mark.parametrize("jitter", [0.0, 0.3, 0.5])
def test_backoff_delay_matches_jax(jitter):
    rows = []
    for _, agent_mod, _ in SIDES:
        rng = random.Random(7)
        rows.append([agent_mod.backoff_delay(k, base_s=0.5, factor=2.0,
                                             cap_s=6.0, jitter=jitter,
                                             rng=rng)
                     for k in range(0, 9)])
    assert rows[1] == rows[0]
    if jitter == 0.0:
        assert rows[1] == [0.5, 0.5, 1.0, 2.0, 4.0, 6.0, 6.0, 6.0, 6.0]


# ----------------------------------------------------------- elastic agent
P = 101
# (exit codes, run_time_s, agent keywords): the JAX package's schedules
AGENT_SCHEDULES = {
    "window_ages_out": ([1] * 6 + [0], 100.0,
                        dict(max_restarts=2, restart_window_s=150.0,
                             restart_delay_s=0.0)),
    "unbounded_window": ([1] * 6 + [0], 100.0,
                         dict(max_restarts=2, restart_delay_s=0.0)),
    "burst_in_window": ([5], 1.0, dict(max_restarts=3,
                                       restart_window_s=3600.0,
                                       restart_delay_s=0.0)),
    "exponential": ([1, 1, 1, 0], 0.0, dict(max_restarts=10,
                                            restart_delay_s=1.0,
                                            backoff_factor=2.0)),
    "capped": ([1] * 6 + [0], 0.0, dict(max_restarts=10, restart_delay_s=1.0,
                                        backoff_factor=2.0,
                                        max_restart_delay_s=5.0)),
    "spaced_failures": ([1, 1, 1, 0], 500.0,
                        dict(max_restarts=10, restart_delay_s=1.0,
                             backoff_factor=2.0, restart_window_s=100.0)),
    "preemption_resets_backoff": ([1, 1, P, 1, 0], 0.0,
                                  dict(max_restarts=10, restart_delay_s=1.0,
                                       backoff_factor=2.0)),
    "preemptions_free": ([P] * 5 + [1, 0], 1.0,
                         dict(max_restarts=1, restart_delay_s=0.0)),
    "custom_restartable": ([42, 42, 0], 0.0,
                           dict(max_restarts=0, restart_delay_s=0.0,
                                restartable_exit_codes=(42,))),
    "persistent_preemption": ([P], 0.0, dict(max_restarts=3,
                                             restart_delay_s=0.0,
                                             max_preemption_restarts=5)),
    "jittered": ([1, 1, P, 1, 1, 0], 3.0,
                 dict(max_restarts=10, restart_delay_s=1.0, jitter=0.3)),
}


def _run_agent(agent_mod, fi, codes, run_time_s, kw):
    clock = fi.FakeClock()
    group = fi.ScriptedWorkerGroup(codes, clock=clock, run_time_s=run_time_s)
    kw = dict(kw)
    kw.setdefault("jitter", 0.0)
    random.seed(11)          # the agent's jitter draws from the module RNG
    agent = agent_mod.ElasticAgent(group.spawn, group.monitor,
                                   time_fn=clock.time, sleep_fn=clock.sleep,
                                   **kw)
    rc = agent.run()
    return {"rc": rc, "spawns": group.spawns,
            "restart_count": agent.restart_count,
            "preemption_restarts": agent.preemption_restarts,
            "sleeps": clock.sleeps, "now": clock.now}


@pytest.mark.parametrize("name", sorted(AGENT_SCHEDULES))
def test_elastic_agent_matches_jax(name):
    codes, run_time_s, kw = AGENT_SCHEDULES[name]
    want, got = (_run_agent(a, f, codes, run_time_s, kw) for _, a, f in SIDES)
    assert got == want
    if name == "preemption_resets_backoff":
        assert got["sleeps"] == [1.0, 2.0, 1.0, 1.0]
    if name == "preemptions_free":
        assert (got["rc"], got["preemption_restarts"],
                got["restart_count"]) == (0, 5, 1)


def test_preemption_exit_code_is_the_agents_restartable_code():
    assert tel.PREEMPTION_EXIT_CODE == jel.PREEMPTION_EXIT_CODE == 101
    agent = tagent.ElasticAgent(lambda: [], lambda p: 0)
    assert agent.restartable_exit_codes == frozenset({101})


# -------------------------------------------------------- preemption handler
def _handler_trace(el, scenario):
    events = []
    peer = {"v": False}
    kw = dict(exit_fn=lambda code: events.append(code))
    ckpt = (lambda: events.append("ckpt"))
    if scenario == "failing_checkpoint":
        def ckpt():
            raise IOError("filesystem already gone")
    if scenario in ("deferred", "consensus"):
        kw["defer"] = True
    if scenario == "consensus":
        kw["consensus_fn"] = lambda local: local or peer["v"]
    h = el.PreemptionHandler(ckpt, **kw)
    trace = []
    if scenario in ("deferred", "consensus"):
        h.poll()
        trace.append((list(events), h.preempted))
    if scenario == "consensus":
        peer["v"] = True
        h.poll()
    else:
        h.trigger(reason="maintenance event")
        trace.append((list(events), h.preempted))
        h.poll()
    trace.append((list(events), h.preempted))
    h.trigger()            # a second notice is ignored
    h.poll()
    trace.append((list(events), h.preempted))
    return trace


@pytest.mark.parametrize("scenario", ["immediate", "failing_checkpoint",
                                      "deferred", "consensus"])
def test_preemption_handler_matches_jax(scenario):
    want, got = (_handler_trace(el, scenario) for el, _, _ in SIDES)
    assert got == want
    assert got[-1][0][-1] == 101


def test_sigterm_hook_installs_checkpoints_and_restores():
    saves = []
    prev = signal.getsignal(signal.SIGTERM)
    with tel.PreemptionHandler(lambda: saves.append(1)) as h:
        with pytest.raises(SystemExit) as ei:
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(100):     # the handler runs at a bytecode boundary
                time.sleep(0.01)
        assert ei.value.code == tel.PREEMPTION_EXIT_CODE
        assert saves == [1] and h.preempted
    assert signal.getsignal(signal.SIGTERM) is prev


# -------------------------------------------------------------- batch ladder
LADDER = {"elasticity": {"enabled": True, "max_train_batch_size": 10000,
                         "micro_batch_sizes": [8, 12, 16, 17],
                         "min_gpus": 32, "max_gpus": 1500}}
SMALL = {"elasticity": {"enabled": True, "max_train_batch_size": 64,
                        "micro_batch_sizes": [2, 4, 6], "min_gpus": 1,
                        "max_gpus": 8, "prefer_larger_batch": False}}


def _ladder(el, cfg, **kw):
    try:
        return ("ok", el.compute_elastic_config(cfg, **kw))
    except el.ElasticityError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", ["basic", "world", "microbatch", "small",
                                  "small_world", "incompatible", "disabled",
                                  "bad_micro", "bad_gpus", "bad_version"])
def test_compute_elastic_config_matches_jax(case):
    cfg, kw = LADDER, {}
    if case == "world":
        kw = {"world_size": 40}
    elif case == "microbatch":
        kw = {"return_microbatch": True}
    elif case == "small":
        cfg = SMALL
    elif case == "small_world":
        cfg, kw = SMALL, {"world_size": 3}
    elif case == "incompatible":
        kw = {"world_size": 31}
    elif case == "disabled":
        cfg = {"elasticity": {"enabled": False}}
    elif case == "bad_micro":
        cfg = {"elasticity": {"enabled": True, "micro_batch_sizes": [0, 4]}}
    elif case == "bad_gpus":
        cfg = {"elasticity": {"enabled": True, "min_gpus": 4, "max_gpus": 2}}
    elif case == "bad_version":
        cfg = {"elasticity": {"enabled": True, "version": 0.3}}
    want, got = (_ladder(el, cfg, **kw) for el, _, _ in SIDES)
    assert got == want
    if case == "basic":
        batch, gpus = got[1]
        assert batch <= 10000 and gpus
        assert all(any(batch % (m * g) == 0 for m in (8, 12, 16, 17))
                   for g in gpus)
    if case in ("incompatible", "disabled", "bad_micro"):
        assert got[0] != "ok"


def test_candidate_batches_and_valid_gpus_match_jax():
    for micro, cap in (([2, 4, 6], 64), ([8, 12, 16, 17], 10000), ([3], 1)):
        assert tel.get_candidate_batch_sizes(micro, cap) == \
            jel.get_candidate_batch_sizes(micro, cap)
        for batch in (48, 96, 1632):
            assert tel.get_valid_gpus(batch, micro, 1, 64) == \
                jel.get_valid_gpus(batch, micro, 1, 64)
    assert tel.elasticity_enabled(LADDER) and not tel.elasticity_enabled({})


def test_elasticity_section_parses_as_the_reference():
    cfg = {"train_batch_size": 8, **SMALL}
    parsed = TConfig(cfg)
    assert parsed.elasticity_enabled and parsed.not_ported() == []
    conf = tel.ElasticityConfig(**SMALL["elasticity"]).validate()
    ref = jel.ElasticityConfig(**SMALL["elasticity"]).validate()
    for key in ("max_train_batch_size", "micro_batch_sizes", "min_gpus",
                "max_gpus", "min_time", "prefer_larger_batch", "version",
                "ignore_non_elastic_batch_info", "model_parallel_size"):
        assert getattr(conf, key) == getattr(ref, key), key
