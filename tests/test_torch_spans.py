"""The span tracer of the port (telemetry/spans.py, ``ServingEngine(
tracer=...)``) held against the JAX package's on the CPU.

* ``SpanTracer`` on scripted calls (begin, end, record, a context-carrying
  trace, the bounded buffer and its drop count, a sink, ``spans_for`` /
  ``trace_ids`` / ``clear``, the Chrome trace and its file) and the
  analyses (``phase_breakdown``, ``trace_summaries``,
  ``aggregate_phase_stats``) give JAX's records.
* A tracer-armed ``ServingEngine`` on the tiny LLaMA in fp32 and a virtual
  clock, beside JAX's: the same spans (name, trace, span, parent, start,
  end, attributes) and ``trace_summaries``, through chunked prefill,
  preemption with swap, speculative steps and a cancel; slot- and
  block-paged. The armed engine's greedy tokens equal a bare one's.
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
from deepspeed_tpu.serving import Request as JRequest
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.telemetry import spans as jspans
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.inference.weights import llama_params_from_numpy
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.serving import Request, ServingEngine
from deepspeed_tpu_torch.telemetry import spans as tspans

VOCAB = 512


class VirtualClock:
    def __init__(self, dt=0.001):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


class ListSink:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)


def _script(mod):
    """The same calls on either package's tracer; returns the tracer, its
    sink, and what the calls returned."""
    sink = ListSink()
    tr = mod.SpanTracer(time_fn=VirtualClock(0.5), sink=sink, max_spans=6)
    root = tr.begin("request", t=1.0, rid=7, priority=0)
    q = tr.record("queue_wait", 1.0, 1.25, trace_id=root.trace_id,
                  parent_id=root.span_id, slot=2)
    dec = tr.begin("decode_segment", trace_id=root.trace_id,
                   parent_id=root.span_id, t=1.5, slot=2)
    tr.end(dec, t=1.25, tokens=4)          # before its start: clamped
    again = tr.end(dec, t=9.0)             # already ended: untouched
    tr.end(None)
    pf = tr.record("prefill_chunk", 1.25, 1.5, trace_id=root.trace_id,
                   parent_id=root.span_id, program="prefill_16", tokens=9)
    clocked = tr.begin("swap_out", trace_id=root.trace_id)   # clock read
    tr.end(clocked)
    other = tr.new_trace()
    ctx = tr.record("router_queue", 0.0, 2.0, trace_id=other)
    tr.record("swapped", 2.0, 3.5, trace_id=other, parent_id=ctx.span_id)
    tr.end(root, t=4.0, finish_reason="length", tokens=5)
    dropped = tr.record("decode_step", 4.0, 4.5)            # past max_spans
    return tr, sink, (root, q, dec, again, pf, clocked, ctx, dropped)


def _as_dicts(spans):
    return [s.as_dict() for s in spans]


def test_span_tracer_matches_jax_on_scripted_calls(tmp_path):
    ours, osink, oret = _script(tspans)
    ref, rsink, rret = _script(jspans)
    assert _as_dicts(ours.spans) == _as_dicts(ref.spans)
    assert osink.records == rsink.records
    assert [s.as_dict() for s in oret] == [s.as_dict() for s in rret]
    assert [repr(s) for s in oret] == [repr(s) for s in rret]
    assert (ours.dropped, len(ours.spans)) == (ref.dropped, len(ref.spans))
    assert ours.dropped == 2
    assert repr(ours) == repr(ref)
    assert ours.trace_ids() == ref.trace_ids()
    tid = ours.trace_ids()[0]
    assert _as_dicts(ours.spans_for(tid)) == _as_dicts(ref.spans_for(tid))
    assert ours.to_chrome_trace() == ref.to_chrome_trace()
    path = ours.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(ref.to_chrome_trace()))
    assert tspans.PHASE_OF_SPAN == jspans.PHASE_OF_SPAN
    assert tspans.PHASES == jspans.PHASES
    for spans, jax_spans in ((ours.spans, ref.spans),
                             (osink.records, rsink.records)):
        assert tspans.phase_breakdown(spans) == \
            jspans.phase_breakdown(jax_spans)
        summ = tspans.trace_summaries(spans)
        assert summ == jspans.trace_summaries(jax_spans)
        assert tspans.aggregate_phase_stats(summ) == \
            jspans.aggregate_phase_stats(summ)
    assert tspans.aggregate_phase_stats([]) == {}
    ours.clear()
    assert ours.spans == [] and ours.dropped == 0


# ------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def engines():
    groups.reset()
    jeng = deepspeed_tpu.init_inference(JLlamaModel(JLlamaConfig.tiny()),
                                        dtype="fp32", max_out_tokens=128)
    params = llama_params_from_numpy(jax.device_get(jeng.params), "cpu",
                                     torch.float32)
    teng = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig.tiny()), dtype="fp32", device="cpu",
        params=params)
    return jeng, teng


def _trace():
    """Three class-1 requests with 40-token prompts (chunked at 16) fill
    the slots; two class-0 requests arrive later and preempt; one request
    carries trace context; one is cancelled while queued."""
    rng = np.random.RandomState(5)
    reqs = [dict(rid=i, prompt=rng.randint(0, VOCAB, size=40).tolist(),
                 max_new_tokens=20, priority=1) for i in range(3)]
    reqs += [dict(rid=3 + i, prompt=rng.randint(0, VOCAB, size=9).tolist(),
                  max_new_tokens=6, arrival_time=0.03, priority=0)
             for i in range(2)]
    reqs.append(dict(rid=5, prompt=[3, 1, 4, 1, 5, 9, 2, 6] * 2,
                     max_new_tokens=8, arrival_time=0.04))
    reqs[-1].update(trace_id="t-upstream", parent_span="s-upstream")
    reqs.append(dict(rid=6, prompt=[2, 7] * 4, max_new_tokens=4,
                     arrival_time=5.0))
    return reqs


def _run(srv, cls, cancel_at=2):
    """Submit the trace, step until done, cancelling rid 6 at the
    ``cancel_at``-th step (it waits for a later arrival)."""
    for r in _trace():
        srv.submit(cls(**r))
    srv.warmup()
    out, n = {}, 0
    srv._run_t0 = srv._time()
    while srv.pending:
        n += 1
        if n == cancel_at:
            assert srv.cancel(6)
        for res in srv.step(srv._time() - srv._run_t0):
            out[res.rid] = res.tokens
    return out


def _spans(tracer):
    return [(s.name, s.trace_id, s.span_id, s.parent_id, s.start, s.end,
             s.attrs) for s in tracer.spans]


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["slot_paged", "block_paged"])
def test_armed_engine_spans_match_jax(engines, prefix_cache):
    jeng, teng = engines
    kw = dict(num_slots=3, max_len=128, buckets=(16,),
              prefill_token_budget=16, preemption="swap", telemetry=False,
              speculative=dict(mode="ngram", k_buckets=(2, 4)))
    if prefix_cache:
        kw.update(prefix_cache=True, block_size=16)
    jtr, ttr = jspans.SpanTracer(), tspans.SpanTracer()
    jsrv = JServingEngine(jeng, time_fn=VirtualClock(), tracer=jtr, **kw)
    tsrv = ServingEngine(teng, time_fn=VirtualClock(), tracer=ttr, **kw)
    want, got = _run(jsrv, JRequest), _run(tsrv, Request)
    assert got == want and 6 not in got
    assert tsrv.preemptions == jsrv.preemptions >= 1
    assert _spans(ttr) == _spans(jtr)
    names = {s.name for s in ttr.spans}
    assert {"request", "queue_wait", "prefill_chunk", "decode_segment",
            "swap_out", "swapped", "swap_in", "cancel",
            "spec_draft"} <= names
    assert names & {"decode_step", "spec_verify"}
    assert tspans.trace_summaries(ttr.spans) == \
        jspans.trace_summaries(jtr.spans)
    assert tspans.trace_summaries(ttr.spans)
    upstream = ttr.spans_for("t-upstream")
    assert upstream and all(s.parent_id == "s-upstream" for s in upstream)
    # an armed run issues the same device work: the bare engine's tokens
    bare = ServingEngine(teng, time_fn=VirtualClock(),
                         **{k: v for k, v in kw.items()})
    assert _run(bare, Request) == got
