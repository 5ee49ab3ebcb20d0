"""Flight recorder of the port (port of
deepspeed_tpu/telemetry/flight_recorder.py): bounded rings of the most
recent spans, events, metric snapshots and SLO evaluations, teed off the
streams the telemetry already writes, and one self-contained postmortem
JSON per trigger.

The recorder observes records through :meth:`FlightRecorder.tee`, a sink
wrapper that records, then forwards: arming it changes no write site and
costs one deque append per record. Triggers (wired today: the SLO
engine's page-severity alerts) write
``<dump_dir>/flight_<NNN>_<reason>.json``, numbered in order with no
wall-clock in the name (a virtual-clock run gives stable paths), and fire
a ``telemetry/flight_dump`` event; a per-reason cooldown bounds the dumps
of an incident storm. Ring evictions are expected (the window is
bounded) and counted apart from upstream drops: a dump's ``complete``
flag says whether the telemetry pipeline itself dropped anything
(``telemetry/spans_dropped`` / ``telemetry/events_dropped`` since the
recorder was armed).
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry, get_registry


class _TeeSink:
    """Records every write into the recorder's rings, then forwards to
    the wrapped sink (which may be None — recorder-only capture)."""

    def __init__(self, recorder: "FlightRecorder", inner=None):
        self.recorder = recorder
        self.inner = inner

    def write(self, record: dict) -> None:
        try:
            self.recorder.observe(record)
        except Exception:   # the recorder must never take down the job
            pass
        if self.inner is not None:
            self.inner.write(record)

    def flush(self) -> None:
        if self.inner is not None:
            self.inner.flush()

    def close(self) -> None:
        if self.inner is not None:
            self.inner.close()

    def __getattr__(self, name):
        # sink-protocol extras (scalar(), records_written...) pass through
        if self.inner is None:
            raise AttributeError(name)
        return getattr(self.inner, name)


class FlightRecorder:
    """Bounded rings of recent telemetry + one-call postmortem dumps.

    Parameters
    ----------
    dump_dir: where :meth:`trigger` writes its JSON artifacts; None
        records triggers (ring + counter + event) without writing —
        :meth:`dump` with an explicit path still works.
    max_spans / max_events / max_snapshots / max_alerts: ring bounds.
        Evictions are counted in ``ring_evicted`` (expected, not data
        loss).
    registry: the registry whose snapshot rides in every dump and whose
        ``telemetry/flight_dumps`` counter/event fire per trigger.
        Defaults to the process-global registry.
    trigger_cooldown: minimum number of OBSERVED records between two
        auto-triggers of the same reason — a crash loop must not write
        a thousand identical dumps. 0 disables the gate.
    """

    def __init__(self, *, dump_dir: Optional[str] = None,
                 max_spans: int = 4096, max_events: int = 2048,
                 max_snapshots: int = 32, max_alerts: int = 256,
                 registry: Optional[MetricsRegistry] = None,
                 trigger_cooldown: int = 0):
        self.dump_dir = dump_dir
        self.registry = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self.spans: deque = deque(maxlen=max_spans)
        self.events: deque = deque(maxlen=max_events)
        self.snapshots: deque = deque(maxlen=max_snapshots)
        self.alerts: deque = deque(maxlen=max_alerts)
        self.ring_evicted: Dict[str, int] = {
            "spans": 0, "events": 0, "snapshots": 0, "alerts": 0}
        self.observed = 0
        self.dumps: List[dict] = []          # trigger summaries, in order
        self._n_dumps = 0
        self.trigger_cooldown = int(trigger_cooldown)
        self._last_trigger_obs: Dict[str, int] = {}
        # completeness baseline: the pipeline drop counters live on the
        # PROCESS-GLOBAL registry (JsonlSink/SpanTracer count there no
        # matter which registry their records feed), so the verdict
        # must read them there — and as a DELTA since this recorder was
        # armed, so drops from an earlier unrelated run cannot taint a
        # fresh recorder's dumps
        self._drop_baseline = self._upstream_drop_counts()

    @staticmethod
    def _upstream_drop_counts() -> Dict[str, int]:
        counters = get_registry()._counters
        return {
            "spans": counters["telemetry/spans_dropped"].value
            if "telemetry/spans_dropped" in counters else 0,
            "events": counters["telemetry/events_dropped"].value
            if "telemetry/events_dropped" in counters else 0,
        }

    # ------------------------------------------------------------- capture
    def tee(self, inner=None) -> _TeeSink:
        """A sink that records-then-forwards — attach it wherever a
        JsonlSink goes (``registry.attach_sink(rec.tee(sink))``,
        ``SpanTracer(sink=rec.tee(sink))``)."""
        return _TeeSink(self, inner)

    def _push(self, ring_name: str, ring: deque, record: dict) -> None:
        if ring.maxlen is not None and len(ring) == ring.maxlen:
            self.ring_evicted[ring_name] += 1
        ring.append(record)

    def observe(self, record: dict) -> None:
        """Classify one telemetry record into its ring. Unknown kinds
        land in the events ring — a postmortem prefers noise over a
        blind spot."""
        kind = record.get("kind")
        with self._lock:
            self.observed += 1
            if kind == "span":
                self._push("spans", self.spans, record)
            elif kind == "snapshot":
                self._push("snapshots", self.snapshots, record)
            elif kind in ("slo_eval",):
                self._push("alerts", self.alerts, record)
            else:
                self._push("events", self.events, record)

    def note_alert(self, record: dict) -> None:
        """Direct entry into the alert ring (the SLO engine pushes its
        per-evaluation records here even when no sink is attached)."""
        with self._lock:
            self.observed += 1
            self._push("alerts", self.alerts, record)

    # -------------------------------------------------------------- dumps
    def _payload(self, reason: str, context: dict) -> dict:
        drops = self._upstream_drop_counts()
        spans_dropped = drops["spans"] - self._drop_baseline["spans"]
        events_dropped = drops["events"] - self._drop_baseline["events"]
        with self._lock:
            payload = {
                "kind": "flight_dump",
                "reason": reason,
                "context": context,
                "spans": list(self.spans),
                "events": list(self.events),
                "snapshots": list(self.snapshots),
                "alerts": list(self.alerts),
                "ring_evicted": dict(self.ring_evicted),
                "observed": self.observed,
            }
        payload["metrics"] = self.registry.snapshot()
        # completeness: ring evictions are the recorder doing its
        # bounded-window job; upstream drops mean the record itself has
        # holes — the postmortem must say so
        payload["upstream_dropped"] = {"spans": spans_dropped,
                                       "events": events_dropped}
        payload["complete"] = spans_dropped == 0 and events_dropped == 0
        return payload

    def dump(self, path: Optional[str], reason: str, **context) -> dict:
        """Freeze the current pre-incident window as one self-contained
        JSON object; returns the payload (``path`` key always present —
        the written file, or None with ``write_error`` / when no path
        was given). Never raises on I/O failure (the incident being
        dumped may BE a disk problem) — the payload is still returned,
        counted, and evented."""
        payload = self._payload(reason, context)
        payload["path"] = None
        if path is not None:
            try:
                parent = os.path.dirname(os.path.abspath(path))
                os.makedirs(parent, exist_ok=True)
                with open(path, "w") as f:
                    json.dump(payload, f, default=str)
                payload["path"] = path
            except Exception as e:
                payload["write_error"] = f"{type(e).__name__}: {e}"
        self._n_dumps += 1
        self.dumps.append({"reason": reason, "path": payload["path"],
                           "context": context})
        self.registry.event("telemetry/flight_dump", reason=reason,
                            path=payload["path"], **context)
        return payload

    def trigger(self, reason: str, **context) -> Optional[dict]:
        """Auto-trigger seam for the wired incident paths (the SLO
        engine's page alerts).
        Writes ``<dump_dir>/flight_<NNN>_<reason>.json`` when a
        ``dump_dir`` is configured; otherwise records the trigger
        without an artifact. Cooldown-gated per reason so an incident
        storm produces a bounded number of dumps. Returns the payload,
        or None when cooldown-suppressed."""
        if self.trigger_cooldown:
            last = self._last_trigger_obs.get(reason)
            if last is not None \
                    and self.observed - last < self.trigger_cooldown:
                return None
            self._last_trigger_obs[reason] = self.observed
        path = os.path.join(self.dump_dir,
                            f"flight_{self._n_dumps:03d}_{reason}.json") \
            if self.dump_dir is not None else None
        return self.dump(path, reason, **context)

    def __repr__(self):
        return (f"FlightRecorder(spans={len(self.spans)}, "
                f"events={len(self.events)}, alerts={len(self.alerts)}, "
                f"snapshots={len(self.snapshots)}, dumps={self._n_dumps}, "
                f"dir={self.dump_dir!r})")
