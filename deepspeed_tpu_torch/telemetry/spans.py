"""Span-graph request tracer of the port (port of
deepspeed_tpu/telemetry/spans.py).

The Dapper span model (Sigelman et al., 2010) over the iteration-level
serving loop: every request is a TRACE, a tree of SPANS linked by
``(trace, span, parent)`` ids, so an aggregate such as "TPOT p99 moved"
breaks down into named phases (queue wait, prefill chunks, decode
segments, swaps) of named programs.

* No device work of its own. Spans are stamped on the host, at fences that
  already exist (token reads, swap round trips), with instants the caller
  already holds: given an explicit ``t`` the tracer reads no clock, so an
  armed serving run issues the same device work as a bare one.
* Any clock: times are plain floats in the caller's clock (the serving
  engine's, a virtual clock in tests), so a virtual-clock trace replays its
  span graph exactly.
* Trace context is two fields on ``Request`` (``trace_id``,
  ``parent_span``): a request that arrives with them keeps its trace.

Finished spans go to a bounded in-memory buffer and, with a sink, to the
telemetry JSONL as ``{"kind": "span", ...}`` records;
:meth:`SpanTracer.to_chrome_trace` gives the Chrome trace-event JSON that
Perfetto loads (one track per trace).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

# span name -> lifecycle phase for per-request critical-path accounting
# (names outside this map — roots, engine-scope iteration spans — carry
# structure, not phase time, and are skipped by the breakdown)
PHASE_OF_SPAN = {
    "queue_wait": "queue",          # arrival -> admission (engine)
    "router_queue": "queue",        # submit/requeue -> dispatch (a router)
    "prefill_chunk": "prefill",     # one prefill program call (per chunk)
    "decode_segment": "decode",     # decode-phase residency in a slot
    "swap_out": "swapped",          # preemption KV extract -> host
    "swapped": "swapped",           # parked off the slot set
    "swap_in": "swapped",           # host KV -> HBM on resume
    "failover": "failover",         # replica death -> re-dispatched
}

PHASES = ("queue", "prefill", "decode", "swapped", "failover")


class Span:
    """One closed (or still-open) span. Times are caller-clock floats;
    ``end`` is None while open. ``attrs`` is a flat dict of small JSON
    values (slot, bucket, program, reason...)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end", "attrs")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, start: float,
                 end: Optional[float] = None,
                 attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = float(start)
        self.end = None if end is None else float(end)
        self.attrs = attrs or {}

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else max(self.end - self.start, 0.0)

    def as_dict(self) -> dict:
        d = {"kind": "span", "trace": self.trace_id, "span": self.span_id,
             "parent": self.parent_id, "name": self.name,
             "start": self.start, "end": self.end}
        if self.end is not None:
            d["dur_ms"] = (self.end - self.start) * 1e3
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    def __repr__(self):
        return (f"Span({self.name}, trace={self.trace_id}, "
                f"span={self.span_id}, parent={self.parent_id}, "
                f"start={self.start:.6f}, end={self.end})")


class SpanTracer:
    """Allocates trace/span ids, buffers finished spans, streams them to
    a JSONL sink, and exports Chrome-trace JSON.

    Ids are deterministic per tracer (monotonic counters, not random):
    two runs of the same virtual-clock trace give the same span graph.

    ``time_fn`` is only a fallback: the serving engine passes explicit
    ``t`` values it already holds, so arming the tracer against a virtual
    clock never moves that clock.

    Id allocation and buffer appends take a lock (more than one thread may
    record).
    """

    def __init__(self, *, time_fn=None, sink=None, max_spans: int = 200_000):
        self._time = time_fn or time.monotonic
        self.sink = sink
        self.max_spans = int(max_spans)
        self._lock = threading.Lock()
        self._next_trace = 0
        self._next_span = 0
        self.spans: List[Span] = []        # finished spans, append order
        self.dropped = 0                   # finished spans past max_spans
        self._drop_warned = False

    # ------------------------------------------------------------------ ids
    def new_trace(self) -> str:
        with self._lock:
            tid = self._next_trace
            self._next_trace += 1
        return f"t{tid:08x}"

    def _new_span_id(self) -> str:
        with self._lock:
            sid = self._next_span
            self._next_span += 1
        return f"s{sid:08x}"

    def now(self) -> float:
        """Fallback clock read — prefer passing explicit ``t``."""
        return self._time()

    # ---------------------------------------------------------------- spans
    def begin(self, name: str, *, trace_id: Optional[str] = None,
              parent_id: Optional[str] = None, t: Optional[float] = None,
              **attrs) -> Span:
        """Open a span (allocating a fresh trace when ``trace_id`` is
        None). The span is not in :attr:`spans` until :meth:`end`."""
        if trace_id is None:
            trace_id = self.new_trace()
        return Span(trace_id, self._new_span_id(), parent_id, name,
                    self.now() if t is None else t, attrs=attrs)

    def end(self, span: Optional[Span], t: Optional[float] = None,
            **attrs) -> Optional[Span]:
        """Close an open span and commit it to the buffer/sink. None-safe
        (callers end whatever handle they hold without re-checking the
        armed state). A span already ended is left untouched."""
        if span is None or span.end is not None:
            return span
        span.end = self.now() if t is None else float(t)
        if span.end < span.start:          # out-of-order virtual stamps
            span.end = span.start
        if attrs:
            span.attrs.update(attrs)
        self._commit(span)
        return span

    def record(self, name: str, start: float, end: float, *,
               trace_id: Optional[str] = None,
               parent_id: Optional[str] = None, **attrs) -> Span:
        """Stamp an already-elapsed interval as one closed span — the
        fence-friendly primitive: both instants were observed at fences
        that already existed, nothing blocks here."""
        if trace_id is None:
            trace_id = self.new_trace()
        span = Span(trace_id, self._new_span_id(), parent_id, name,
                    start, max(end, start), attrs=attrs)
        self._commit(span)
        return span

    def _commit(self, span: Span) -> None:
        dropped = False
        with self._lock:
            if len(self.spans) < self.max_spans:
                self.spans.append(span)
            else:
                self.dropped += 1
                dropped = True
        if dropped:
            # a silent drop would let a reader claim completeness the
            # buffer does not have: count every drop, warn once
            try:
                from deepspeed_tpu_torch.telemetry.registry import get_registry

                get_registry().counter("telemetry/spans_dropped").inc()
            except Exception:
                pass
            if not self._drop_warned:
                self._drop_warned = True
                try:
                    from deepspeed_tpu_torch.utils.logging import logger

                    logger.warning(
                        f"SpanTracer buffer full ({self.max_spans} spans): "
                        f"further spans are dropped from the in-memory "
                        f"buffer (counted in telemetry/spans_dropped; "
                        f"JSONL streaming, if armed, continues)")
                except Exception:
                    pass
        if self.sink is not None:
            try:
                self.sink.write(span.as_dict())
            except Exception:   # tracing must never take down the job
                pass

    # -------------------------------------------------------------- queries
    def spans_for(self, trace_id: str) -> List[Span]:
        with self._lock:
            return [s for s in self.spans if s.trace_id == trace_id]

    def trace_ids(self) -> List[str]:
        seen, out = set(), []
        with self._lock:
            for s in self.spans:
                if s.trace_id not in seen:
                    seen.add(s.trace_id)
                    out.append(s.trace_id)
        return out

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.dropped = 0

    # -------------------------------------------------------------- exports
    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` form
        Perfetto/chrome://tracing load directly): one complete ("X")
        event per finished span, one tid TRACK per trace so a request's
        lifecycle reads left-to-right on its own row. Times are mapped
        caller-clock seconds -> microseconds."""
        with self._lock:
            spans = list(self.spans)
        tids: Dict[str, int] = {}
        events = []
        for s in spans:
            if s.end is None:
                continue
            tid = tids.setdefault(s.trace_id, len(tids))
            args = {"trace": s.trace_id, "span": s.span_id}
            if s.parent_id:
                args["parent"] = s.parent_id
            args.update(s.attrs)
            events.append({
                "name": s.name,
                "cat": PHASE_OF_SPAN.get(s.name, "span"),
                "ph": "X",
                "ts": round(s.start * 1e6, 3),
                "dur": round((s.end - s.start) * 1e6, 3),
                "pid": 0,
                "tid": tid,
                "args": args,
            })
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": f"trace {trace}"}}
                for trace, tid in tids.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Write :meth:`to_chrome_trace` to ``path``; load the file at
        https://ui.perfetto.dev (or chrome://tracing)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def __repr__(self):
        return (f"SpanTracer(spans={len(self.spans)}, "
                f"traces={self._next_trace}, dropped={self.dropped})")


# ------------------------------------------------------- span-graph analysis
def _get(rec, key, default=None):
    """Field access over either Span objects or JSONL span dicts."""
    if isinstance(rec, Span):
        return {"trace": rec.trace_id, "span": rec.span_id,
                "parent": rec.parent_id, "name": rec.name,
                "start": rec.start, "end": rec.end,
                "attrs": rec.attrs}.get(key, default)
    return rec.get(key, default)


def phase_breakdown(spans: Iterable) -> Dict[str, float]:
    """Seconds spent per lifecycle phase over one trace's spans (Span
    objects or JSONL dicts). Only closed spans whose name maps to a
    phase count; structural spans (roots, engine iteration spans) are
    skipped — for a single-slot request the phases are sequential, so
    the sum approximates the root span's duration."""
    out = {p: 0.0 for p in PHASES}
    for s in spans:
        phase = PHASE_OF_SPAN.get(_get(s, "name"))
        end = _get(s, "end")
        if phase is None or end is None:
            continue
        out[phase] += max(end - _get(s, "start", 0.0), 0.0)
    return out


def trace_summaries(spans: Iterable,
                    root_name: str = "request") -> List[dict]:
    """Per-trace lifecycle summary over a mixed span stream: one dict
    per trace that has a closed ``root_name`` span, with total seconds,
    per-phase seconds, and per-phase FRACTIONS of the root duration —
    the critical-path view ("this request spent 60% of its life in
    queue, 5% prefilling, 30% decoding, 5% swapped out")."""
    by_trace: Dict[str, List] = {}
    for s in spans:
        by_trace.setdefault(_get(s, "trace"), []).append(s)
    out = []
    for trace, group in by_trace.items():
        roots = [s for s in group
                 if _get(s, "name") == root_name and _get(s, "end")
                 is not None]
        if not roots:
            continue
        root = roots[0]
        total = max(_get(root, "end") - _get(root, "start"), 0.0)
        phases = phase_breakdown(group)
        fractions = {p: (phases[p] / total if total > 0 else 0.0)
                     for p in PHASES}
        out.append({
            "trace": trace,
            "root_span": _get(root, "span"),
            "total_s": total,
            "phases_s": phases,
            "fractions": fractions,
            "n_spans": len(group),
            "attrs": dict(_get(root, "attrs") or {}),
        })
    return out


def aggregate_phase_stats(summaries: Sequence[dict]) -> dict:
    """p50/p95 of per-request phase fractions and absolute times across
    a run's traces — the report's ``spans`` section payload."""
    if not summaries:
        return {}

    def pct(xs: List[float], p: float) -> float:
        xs = sorted(xs)
        return xs[min(int(len(xs) * p), len(xs) - 1)]

    out: Dict[str, dict] = {"n_requests": len(summaries)}
    totals = [s["total_s"] for s in summaries]
    out["total_ms"] = {"p50": pct(totals, 0.5) * 1e3,
                       "p95": pct(totals, 0.95) * 1e3}
    for phase in PHASES:
        fr = [s["fractions"][phase] for s in summaries]
        ab = [s["phases_s"][phase] for s in summaries]
        if not any(ab):
            continue
        out[phase] = {
            "frac_p50": round(pct(fr, 0.5), 4),
            "frac_p95": round(pct(fr, 0.95), 4),
            "ms_p50": round(pct(ab, 0.5) * 1e3, 3),
            "ms_p95": round(pct(ab, 0.95) * 1e3, 3),
        }
    return out
