"""Speculative decoding of the port (serving/speculative.py, the verify and
draft programs, ``ServingEngine(speculative=...)``) held against the JAX
package on the CPU.

* ``speculative_acceptance``: greedy ``out_tokens`` / ``n_emit`` equal the
  JAX rule's bit for bit (B 4, k 4, V 64, draft lengths 0 to k); sampled,
  the emitted tokens pass a chi-squared test against the filtered target
  softmax (JAX's ``filter_logits`` and softmax) at the temperatures and
  filters of the JAX package's own rejection-sampling tests, with heavy
  rejection traffic. The verify programs' tail packs tokens and counts,
  inactive rows masked, into the one tensor ``verify_to_host`` splits.
* ``ngram_propose``, ``AdaptiveK``, ``pick_k_bucket``,
  ``SpeculativeConfig`` / ``normalize_speculative``: the same values and
  the same errors as the JAX package's.
* The slot-paged multi-token KV write (ops/attention.write_kv_cache with a
  per-slot index) equals the full-layer ``where`` form it replaced and JAX's
  scatter with ``mode="drop"``, for T in {1, 3, 9} with indices up to S.
* ``ServingEngine`` on the tiny LLaMA in fp32 (the JAX engine's weights
  through the weight bridge, virtual clocks): n-gram and draft-model modes,
  slot-paged and block-paged over an int8 pool; the port's speculative
  greedy tokens equal JAX's speculative tokens and the port's plain greedy
  tokens, with a prefill budget and preemption too; the program names and
  counts as JAX's, each one entry; EOS inside an accepted block; TPOT over
  decode invocations; the lookahead error in ``submit``; the
  ``serving/spec_*`` metrics equal to JAX's.

Both engines of a comparison are built from one module fixture; the JAX
draft model is the smallest LLaMA that keeps the target's vocabulary.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.engine import filter_logits as jfilter_logits
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu.ops.attention import write_kv_cache as jwrite_kv_cache
from deepspeed_tpu.serving import Request as JRequest
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving import speculative as jspec
from deepspeed_tpu.telemetry import MetricsRegistry as JMetricsRegistry
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.inference.weights import llama_params_from_numpy
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.ops.attention import write_kv_cache
from deepspeed_tpu_torch.serving import (EngineConfigError, Request,
                                         ServingEngine, SlotCapacityError)
from deepspeed_tpu_torch.serving import speculative as tspec
from deepspeed_tpu_torch.telemetry import MetricsRegistry

VOCAB = 512
# the smallest LLaMA over the target's vocabulary: the draft model
DRAFT = dict(vocab_size=VOCAB, max_seq_len=128, num_layers=1, hidden_size=32,
             num_heads=2, num_kv_heads=1, intermediate_size=64)
SERVE = dict(num_slots=4, max_len=128, buckets=(16, 64))
K_BUCKETS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def _module_one_intra_op_thread():
    """torch's intra-op team cut to one thread for the module (its models
    are tiny: every op is a few hundred rows at most; on a host loaded by
    parallel test workers each op's thread barrier cost more than the op),
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class VirtualClock:
    def __init__(self, dt=0.001):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _port_twin(jeng, cfg):
    params = llama_params_from_numpy(jax.device_get(jeng.params), "cpu",
                                     torch.float32)
    return deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig(**cfg)), dtype="fp32", device="cpu",
        params=params)


@pytest.fixture(scope="module")
def engines():
    """(JAX target, port target, JAX draft, port draft), each pair on one
    set of weights."""
    groups.reset()
    jeng = deepspeed_tpu.init_inference(JLlamaModel(JLlamaConfig.tiny()),
                                        dtype="fp32", max_out_tokens=128)
    jdraft = deepspeed_tpu.init_inference(JLlamaModel(JLlamaConfig(**DRAFT)),
                                          dtype="fp32", max_out_tokens=128,
                                          seed=5)
    tiny = dict(vocab_size=VOCAB, max_seq_len=128, num_layers=2,
                hidden_size=64, num_heads=4, num_kv_heads=2,
                intermediate_size=128)
    return jeng, _port_twin(jeng, tiny), jdraft, _port_twin(jdraft, DRAFT)


def _spec(mode, draft, **kw):
    kw.setdefault("k_buckets", K_BUCKETS)
    if mode == "draft":
        kw.update(draft_engine=draft, draft_window=32)
    return dict(mode=mode, **kw)


def _requests(seed=0):
    """Patterned prompts (prompt lookup finds continuations) beside random
    ones, arriving at once."""
    rng = np.random.RandomState(seed)
    pattern = rng.randint(0, VOCAB, size=5).tolist()
    return [(0, pattern * 8, 14), (1, pattern * 4, 9),
            (2, rng.randint(0, VOCAB, size=23).tolist(), 11),
            (3, rng.randint(0, VOCAB, size=7).tolist(), 12),
            (4, rng.randint(0, VOCAB, size=3).tolist(), 6)]


def _serve(srv, reqs, jax_side):
    cls = JRequest if jax_side else Request
    return {r.rid: r for r in srv.run([cls(*r) for r in reqs])}


def _tokens(results):
    return {rid: r.tokens for rid, r in results.items()}


# ------------------------------------------------------------ acceptance
def _acceptance_inputs(seed, b=4, k=4, v=64):
    """Logits, blocks whose drafts follow the argmax for a random number of
    columns, and draft lengths 0, k and in between."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, k + 1, v).astype(np.float32)
    tgt = logits.argmax(-1)
    tokens = rng.randint(0, v, size=(b, k + 1)).astype(np.int32)
    for row in range(b):
        n = rng.randint(0, k + 1)
        tokens[row, 1:1 + n] = tgt[row, :n]
    draft_len = np.array([0, k, 2, 1], np.int32)[:b]
    return logits, tokens, draft_len


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_acceptance_bit_identical_to_jax(seed):
    logits, tokens, draft_len = _acceptance_inputs(seed)
    jout, jn = jspec.speculative_acceptance(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(draft_len),
        jnp.float32(1.0), jax.random.PRNGKey(0), do_sample=False,
        pad_token_id=-1)
    tout, tn = tspec.speculative_acceptance(
        torch.from_numpy(logits), torch.from_numpy(tokens),
        torch.from_numpy(draft_len), 1.0, None, do_sample=False,
        pad_token_id=-1)
    assert tout.dtype == torch.int32 and tn.dtype == torch.int32
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert (tn.numpy() <= draft_len + 1).all() and (tn.numpy() >= 1).all()


def test_verify_result_is_one_packed_tensor_split_on_the_host():
    """The verify programs' tail: JAX's greedy acceptance with the inactive
    row emitting nothing, ``lengths`` advanced by ``n_emit``, tokens and
    counts in one int32 ``[B, k+2]`` tensor that ``verify_to_host``
    splits."""
    from deepspeed_tpu_torch.inference.engine import _acceptance

    logits, tokens, draft_len = _acceptance_inputs(3)
    jout, jn = jspec.speculative_acceptance(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(draft_len),
        jnp.float32(1.0), jax.random.PRNGKey(0), do_sample=False,
        pad_token_id=-1)
    active = np.array([True, True, False, True])
    lengths = torch.tensor([5, 9, 7, 0], dtype=torch.int32)
    start = lengths.clone()
    accept = _acceptance(False, 0, 1.0, -1)
    out_len, packed = accept(
        torch.from_numpy(logits), torch.from_numpy(tokens),
        torch.from_numpy(draft_len), torch.from_numpy(active), lengths,
        torch.tensor(1.0), None)
    assert out_len is lengths
    assert packed.dtype == torch.int32 and packed.shape == (4, 6)
    toks, n_emit = tspec.verify_to_host(packed)
    want_n = np.where(active, np.asarray(jn), 0)
    want_toks = np.where(active[:, None], np.asarray(jout), -1)
    np.testing.assert_array_equal(n_emit, want_n)
    np.testing.assert_array_equal(toks, want_toks)
    np.testing.assert_array_equal(lengths.numpy(), start.numpy() + want_n)


def _chi2(counts, probs):
    expected = counts.sum() * probs
    keep = probs > 0
    return float(((counts[keep] - expected[keep]) ** 2 / expected[keep]).sum())


@pytest.mark.parametrize("row,temp,top_k,top_p,k", [
    ([1.1, 0.2, -0.7], 1.0, 0, 1.0, 2),
    ([0.8, 0.1, -1.2], 0.7, 2, 1.0, 1),
    ([0.9, 0.5, 0.1, -0.4], 0.8, 0, 0.8, 3)],
    ids=["plain", "temp0.7_top_k2", "temp0.8_top_p0.8"])
def test_sampled_acceptance_follows_filtered_target(row, temp, top_k, top_p,
                                                    k):
    """Leviathan's rule for point-mass drafts, half of them the least
    likely token: the emitted tokens follow the target filtered by JAX's
    ``filter_logits`` at the same temperature, top-k and top-p
    (chi-squared, p > 1e-3); a filtered-out token is never emitted, pads
    never are, and both the accept and the reject path run."""
    v, n = len(row), 4000
    probs = np.asarray(jax.nn.softmax(jfilter_logits(
        jnp.asarray([row], jnp.float32) / temp, top_k=top_k, top_p=top_p)))[0]
    logits = torch.tensor(row).expand(n, k + 1, v).contiguous()
    rng = np.random.RandomState(0)
    draft = np.where(rng.rand(n, k) < 0.5, v - 1,
                     rng.randint(0, v, size=(n, k)))
    tokens = torch.from_numpy(np.concatenate(
        [np.zeros((n, 1), np.int64), draft], axis=1))
    gen = torch.Generator().manual_seed(1)
    out, n_emit = tspec.speculative_acceptance(
        logits, tokens, torch.full((n,), k), temp, gen, do_sample=True,
        top_k=top_k, top_p=top_p, pad_token_id=-1)
    out, n_emit = out.numpy(), n_emit.numpy()
    emitted = out[np.arange(k + 1)[None, :] < n_emit[:, None]]
    assert emitted.min() >= 0
    counts = np.bincount(emitted, minlength=v).astype(float)
    assert (counts[probs == 0] == 0).all()
    dof = int((probs > 0).sum()) - 1
    from scipy import stats
    assert stats.chi2.sf(_chi2(counts, probs), dof) > 1e-3
    assert 0 < (n_emit - 1).sum() < n * k


# ---------------------------------------------------- host-side pieces
def test_ngram_propose_matches_jax():
    rng = np.random.RandomState(0)
    cases = [([1, 2, 3, 9, 1, 2, 3, 7, 5, 1, 2, 3], 4, 3, 1),
             ([1, 2, 3, 4], 4, 3, 1), ([5, 1, 9, 4, 1], 2, 3, 1),
             ([3], 4, 3, 1), ([7, 7], 2, 3, 1)]
    for _ in range(40):
        pattern = rng.randint(0, 6, size=rng.randint(1, 5)).tolist()
        hist = pattern * rng.randint(1, 5) + rng.randint(
            0, 6, size=rng.randint(0, 6)).tolist()
        lo = rng.randint(1, 3)
        cases.append((hist, rng.randint(1, 9), lo + rng.randint(0, 3), lo))
    for hist, k, hi, lo in cases:
        want = jspec.ngram_propose(hist, k, max_ngram=hi, min_ngram=lo)
        got = tspec.ngram_propose(hist, k, max_ngram=hi, min_ngram=lo)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    cfg = tspec.SpeculativeConfig(max_ngram=2)
    hists = [case[0] for case in cases[:8]] + [None]
    want = np.array([3, 0, 2, 5, 1, 4, 2, 2, 3])
    d, n = tspec.NgramDrafter(cfg).propose(hists, want, 8)
    jd, jn = jspec.NgramDrafter(jspec.SpeculativeConfig(max_ngram=2)).propose(
        hists, want, 8)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(n, jn)


def test_adaptive_k_and_pick_k_bucket_match_jax():
    rng = np.random.RandomState(1)
    for buckets in ((2, 4, 8), (1,), (3, 5)):
        kw = dict(mode="ngram", k_buckets=buckets, ema_decay=0.6)
        ours = tspec.AdaptiveK(tspec.SpeculativeConfig(**kw), 3)
        ref = jspec.AdaptiveK(jspec.SpeculativeConfig(**kw), 3)
        for _ in range(60):
            slot, drafted = rng.randint(0, 3), rng.randint(0, 9)
            acc = rng.randint(0, drafted + 1)
            if rng.rand() < 0.1:
                ours.reset_slot(slot)
                ref.reset_slot(slot)
            ours.update(slot, acc, drafted)
            ref.update(slot, acc, drafted)
            assert [ours.desired_k(s) for s in range(3)] == \
                [ref.desired_k(s) for s in range(3)]
            np.testing.assert_array_equal(ours.ema, ref.ema)
        for k in range(0, 11):
            assert tspec.pick_k_bucket(k, buckets) == \
                jspec.pick_k_bucket(k, buckets)


BAD_CONFIGS = [dict(mode="beam"), dict(mode="draft"), dict(k_buckets=()),
               dict(k_buckets=(0, 2)), dict(min_ngram=0),
               dict(max_ngram=1, min_ngram=2)]


@pytest.mark.parametrize("kw", BAD_CONFIGS,
                         ids=[str(sorted(k.items())) for k in BAD_CONFIGS])
def test_speculative_config_errors_match_jax(kw):
    with pytest.raises(Exception) as want:
        jspec.SpeculativeConfig(**kw)
    with pytest.raises(EngineConfigError) as got:
        tspec.SpeculativeConfig(**kw)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_speculative_config_and_normalize_match_jax():
    c = tspec.SpeculativeConfig(k_buckets=(8, 2, 4, 4))
    j = jspec.SpeculativeConfig(k_buckets=(8, 2, 4, 4))
    assert (c.k_buckets, c.k_max) == (j.k_buckets, j.k_max) == ((2, 4, 8), 8)
    for spec in (None, False, "off"):
        assert tspec.normalize_speculative(spec) is None
        assert jspec.normalize_speculative(spec) is None
    for spec in ("ngram", {"k_buckets": (3, 1), "max_ngram": 4}):
        ours, ref = (tspec.normalize_speculative(spec),
                     jspec.normalize_speculative(spec))
        assert dataclass_fields(ours) == dataclass_fields(ref)
    assert tspec.normalize_speculative(c) is c
    with pytest.raises(TypeError) as want:
        jspec.normalize_speculative(3)
    with pytest.raises(TypeError) as got:
        tspec.normalize_speculative(3)
    assert str(got.value) == str(want.value)
    assert type(got.value).__name__ == type(want.value).__name__


def dataclass_fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


# ---------------------------------------------------------- KV write
def _where_write(lay, new, idx):
    """The full-layer form the per-slot write replaced."""
    s_max, t = lay.shape[2], new.shape[1]
    j = torch.arange(s_max)[None, :] - idx.to(torch.long)[:, None]
    hit = ((j >= 0) & (j < t))[:, None, :, None]
    rows = torch.take_along_dim(new, j.clamp(0, t - 1)[:, :, None, None],
                                dim=1)
    lay.copy_(torch.where(hit, rows.transpose(1, 2), lay))


@pytest.mark.parametrize("t", [1, 3, 9])
def test_slot_kv_write_moves_new_rows_as_the_where_form(t):
    s, b, hkv, dh, layer = 32, 6, 2, 8, 1
    rng = np.random.RandomState(t)
    kf = rng.randn(2, b, hkv, s, dh).astype(np.float32)
    vf = rng.randn(2, b, hkv, s, dh).astype(np.float32)
    kn = rng.randn(b, t, hkv, dh).astype(np.float32)
    vn = rng.randn(b, t, hkv, dh).astype(np.float32)
    idx = np.array([0, 5, s - t, s - 1, s, 17], np.int32)
    tk, tv = torch.from_numpy(kf.copy()), torch.from_numpy(vf.copy())
    write_kv_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn), layer,
                   torch.from_numpy(idx))
    wk, wv = torch.from_numpy(kf.copy()), torch.from_numpy(vf.copy())
    _where_write(wk[layer], torch.from_numpy(kn), torch.from_numpy(idx))
    _where_write(wv[layer], torch.from_numpy(vn), torch.from_numpy(idx))
    assert torch.equal(tk, wk) and torch.equal(tv, wv)
    jk, jv, _, _ = jwrite_kv_cache(jnp.asarray(kf), jnp.asarray(vf),
                                   jnp.asarray(kn), jnp.asarray(vn), layer,
                                   jnp.asarray(idx))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the slot at S wrote nothing, the one at S - 1 only its first token
    assert torch.equal(tk[layer, 4], torch.from_numpy(kf[layer, 4]))
    assert torch.equal(tk[layer, 3, :, s - 1], torch.from_numpy(kn[3, 0]))


# ------------------------------------------------------------- serving
STORES = {"slot": {}, "block_int8": dict(prefix_cache=True, block_size=16,
                                         kv_dtype="int8")}


@pytest.fixture(scope="module")
def plain(engines):
    """The port's and JAX's plain greedy tokens of :func:`_requests` per
    store (and the port's with EOS for the EOS test)."""
    jeng, teng, _, _ = engines
    out = {}
    for store, kw in STORES.items():
        jsrv = JServingEngine(jeng, telemetry=False, time_fn=VirtualClock(),
                              **SERVE, **kw)
        tsrv = ServingEngine(teng, telemetry=False, time_fn=VirtualClock(),
                             **SERVE, **kw)
        want = _tokens(_serve(jsrv, _requests(), True))
        got = _tokens(_serve(tsrv, _requests(), False))
        assert got == want, store
        out[store] = got
    return out


@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_spec_greedy_equals_jax_and_plain(engines, plain, mode, store):
    jeng, teng, jdraft, tdraft = engines
    kw = STORES[store]
    jsrv = JServingEngine(jeng, telemetry=False, time_fn=VirtualClock(),
                          speculative=_spec(mode, jdraft), **SERVE, **kw)
    tsrv = ServingEngine(teng, telemetry=False, time_fn=VirtualClock(),
                         speculative=_spec(mode, tdraft), **SERVE, **kw)
    want = _serve(jsrv, _requests(), True)
    got = _serve(tsrv, _requests(), False)
    assert _tokens(got) == _tokens(want) == plain[store]
    assert {r: g.decode_calls for r, g in got.items()} == \
        {r: w.decode_calls for r, w in want.items()}
    assert (tsrv.spec_drafted_tokens, tsrv.spec_accepted_tokens,
            tsrv.decode_steps) == (jsrv.spec_drafted_tokens,
                                   jsrv.spec_accepted_tokens,
                                   jsrv.decode_steps)
    assert tsrv.spec_drafted_tokens > 0
    assert tsrv.program_count == jsrv.program_count
    assert tsrv.program_cache_sizes() == jsrv.program_cache_sizes()
    assert set(tsrv.program_cache_sizes().values()) == {1}
    names = set(tsrv.program_cache_sizes())
    assert {f"verify_{kb}" for kb in K_BUCKETS} <= names
    assert ({f"draft_{kb}" for kb in K_BUCKETS} <= names) == (mode == "draft")


def test_spec_with_prefill_budget_and_preemption_matches_jax(engines):
    """Chunked prefill (16-token chunks) and priority preemption with swap
    under self-drafting: long class-1 prompts fill both slots, a class-0
    burst preempts them mid-decode; the tokens equal JAX's and the plain
    engine's, the preemptions and decode calls JAX's."""
    jeng, teng, _, _ = engines
    rng = np.random.RandomState(3)
    reqs = [(i, rng.randint(0, VOCAB, size=40).tolist(), 60, 0.0, 1)
            for i in range(4)]
    reqs += [(4 + i, rng.randint(0, VOCAB, size=9).tolist(), 6, 0.03, 0)
             for i in range(2)]
    kw = dict(num_slots=4, max_len=128, buckets=(16,),
              prefill_token_budget=16, preemption="swap", telemetry=False)
    jsrv = JServingEngine(jeng, time_fn=VirtualClock(), **kw,
                          speculative=_spec("draft", jeng))
    tsrv = ServingEngine(teng, time_fn=VirtualClock(), **kw,
                         speculative=_spec("draft", teng))
    want = _serve(jsrv, reqs, True)
    got = _serve(tsrv, reqs, False)
    base = ServingEngine(teng, telemetry=False, time_fn=VirtualClock(),
                         **SERVE)
    assert _tokens(got) == _tokens(want) == _tokens(_serve(base, reqs, False))
    assert tsrv.preemptions == jsrv.preemptions >= 1
    assert {r: g.decode_calls for r, g in got.items()} == \
        {r: w.decode_calls for r, w in want.items()}
    assert tsrv.spec_accepted_tokens == jsrv.spec_accepted_tokens > 0
    assert tsrv.program_cache_sizes() == jsrv.program_cache_sizes()
    assert tsrv.recompile_count() == 0 and len(tsrv.swap) == 0


def test_eos_inside_accepted_block_truncates_like_plain(engines, plain):
    """Self-drafting accepts whole blocks; an EOS in the middle of one ends
    the request there, as the plain engine (and JAX's) ends it."""
    jeng, teng, _, _ = engines
    stream = plain["slot"][0]
    eos = stream[len(stream) // 2]
    jbase = JServingEngine(jeng, telemetry=False, time_fn=VirtualClock(),
                           eos_token_id=eos, **SERVE)
    want = {rid: (r.tokens, r.finish_reason)
            for rid, r in _serve(jbase, _requests(), True).items()}
    tsrv = ServingEngine(teng, telemetry=False, time_fn=VirtualClock(),
                         eos_token_id=eos, **SERVE,
                         speculative=_spec("draft", teng, k_buckets=(4,)))
    got = {rid: (r.tokens, r.finish_reason)
           for rid, r in _serve(tsrv, _requests(), False).items()}
    assert got == want
    assert got[0][1] == "eos" and got[0][0][-1] == eos
    assert tsrv.spec_accepted_tokens > 0


def test_spec_metrics_and_tpot_match_jax(engines):
    """Self-drafting (drafts the target accepts): decode_calls count verify
    invocations, fewer than the tokens; the ``serving/spec_*`` counters,
    the accepted-tokens histogram, tokens per decode call and the
    acceptance gauges equal JAX's."""
    jeng, teng, _, _ = engines
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    jsrv = JServingEngine(jeng, telemetry=jreg, time_fn=VirtualClock(),
                          speculative=_spec("draft", jeng), **SERVE)
    tsrv = ServingEngine(teng, telemetry=treg, time_fn=VirtualClock(),
                         speculative=_spec("draft", teng), **SERVE)
    want = _serve(jsrv, _requests(), True)
    got = _serve(tsrv, _requests(), False)
    assert _tokens(got) == _tokens(want)
    calls = sum(r.decode_calls for r in got.values())
    assert calls < sum(len(r.tokens) - 1 for r in got.values())
    w, g = jreg.snapshot(), treg.snapshot()
    for name in ("serving/spec_verify_steps", "serving/spec_drafted_tokens",
                 "serving/spec_accepted_tokens", "serving/decode_steps",
                 "serving/slot_iterations_active"):
        assert g["counters"][name] == w["counters"][name], name
    for name in ("serving/accepted_tokens_per_step",
                 "serving/tokens_per_decode_call", "serving/tpot_ms"):
        assert g["histograms"][name]["count"] == \
            w["histograms"][name]["count"], name
    for key in ("max", "p50", "p95"):
        assert g["histograms"]["serving/accepted_tokens_per_step"][key] == \
            w["histograms"]["serving/accepted_tokens_per_step"][key], key
    for name in ("serving/spec_acceptance_rate",
                 "serving/spec_tokens_per_slot_step"):
        assert g["gauges"][name] == pytest.approx(w["gauges"][name]), name
    assert 0.0 < g["gauges"]["serving/spec_draft_overhead_frac"] < 1.0
    assert g["histograms"]["serving/accepted_tokens_per_step"]["max"] > 1


def test_submit_reserves_the_lookahead_as_jax(engines):
    jeng, teng, _, _ = engines
    kw = dict(num_slots=2, max_len=128, buckets=(16,), telemetry=False,
              speculative=dict(mode="ngram", k_buckets=(2, 8)))
    jsrv, tsrv = JServingEngine(jeng, **kw), ServingEngine(teng, **kw)
    with pytest.raises(ValueError) as want:
        jsrv.submit(JRequest(rid=0, prompt=[1] * 10, max_new_tokens=111))
    with pytest.raises(SlotCapacityError, match="lookahead") as got:
        tsrv.submit(Request(rid=0, prompt=[1] * 10, max_new_tokens=111))
    assert str(got.value) == str(want.value)
    tsrv.submit(Request(rid=1, prompt=[1] * 10, max_new_tokens=110))
    with pytest.raises(EngineConfigError, match="leaves no slot capacity"):
        ServingEngine(teng, num_slots=2, max_len=8, buckets=(8,),
                      speculative=dict(k_buckets=(8,)))
    # a draft engine on another device than the target's raises
    elsewhere = SimpleNamespace(device="cuda", module=teng.module)
    with pytest.raises(EngineConfigError, match="one device"):
        ServingEngine(teng, num_slots=2, max_len=128, buckets=(16,),
                      speculative=dict(mode="draft", draft_engine=elsewhere))
