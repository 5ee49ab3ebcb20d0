"""In-process metrics registry of the port (port of
deepspeed_tpu/telemetry/registry.py): counters, gauges and fixed-bucket
histograms.

One registry every hot loop writes into at near-zero cost, snapshotted on
demand:

1. **Overhead.** An update is a dict lookup and an int add (counters), a
   float store (gauges) or a ``bisect`` and an int add (histograms): no
   locks on the update path, no allocation, no device work.
2. **Fixed memory.** Histograms are fixed-bucket (default: log-spaced
   latency buckets, ratio 1.25), so a long serving run costs the same bytes
   as a unit test. Percentiles (p50/p95/p99) are interpolated inside the
   bracketing bucket; min/max/sum/mean are exact.
3. **Pure host Python.** No torch: the registry serves test code that never
   touches a device.

Creation (the first ``counter()/gauge()/histogram()`` call of a name)
takes a lock; updates are single GIL-atomic operations, which suits the one
writer per metric of the engines.
"""

from __future__ import annotations

import re
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence

# the one character class every scraped metric name must reduce to —
# shared by to_prometheus() and metric_label() so a name that is valid
# in-process is valid (and collision-stable) after Prometheus
# sanitization too
_PROM_INVALID = re.compile(r"[^a-zA-Z0-9_:]")
# labels reduce to the [a-zA-Z0-9_] subset: any character the
# Prometheus sanitizer would fold to "_" is folded HERE, so two
# distinct in-process names can never collide only at scrape time
_LABEL_INVALID = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_metric_name(name: str, prefix: str = "dstpu") -> str:
    """Prometheus-exposition name for an in-process metric name
    (``serving/ttft_ms`` -> ``dstpu_serving_ttft_ms``)."""
    out = _PROM_INVALID.sub("_", name)
    return f"{prefix}_{out}" if prefix else out


def metric_label(value) -> str:
    """Sanitize a caller-supplied label value (a priority class) for a
    metric name segment: it must neither break the ``/``-separated name
    paths nor collide after :func:`sanitize_metric_name`. Invalid
    characters (``/`` included) and empty values become ``_``; the length
    is clamped to 64."""
    s = str(value)
    s = _LABEL_INVALID.sub("_", s)[:64]
    return s or "_"


def _default_latency_buckets_ms() -> List[float]:
    """Log-spaced (ratio 1.25) upper bounds from 10us to ~2min, in ms.
    The ratio bounds a percentile's quantization error to ~25% worst case
    (a few % typical after interpolation)."""
    out, v = [], 0.01
    while v < 120_000.0:
        out.append(round(v, 6))
        v *= 1.25
    return out


DEFAULT_LATENCY_BUCKETS_MS: Sequence[float] = tuple(_default_latency_buckets_ms())


class Counter:
    """Monotonic event counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value (None until first set)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with percentile estimation.

    ``buckets`` are ascending upper bounds; observations above the last
    bound land in an overflow bucket whose percentile estimate is the
    observed max (exact). min/max/sum/count are tracked exactly.
    """

    __slots__ = ("name", "buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.buckets = tuple(buckets if buckets is not None
                             else DEFAULT_LATENCY_BUCKETS_MS)
        assert list(self.buckets) == sorted(self.buckets), \
            f"histogram {name}: buckets must be ascending"
        self.counts = [0] * (len(self.buckets) + 1)  # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, p: float) -> Optional[float]:
        """Estimated value at quantile ``p`` in [0, 1]: linear
        interpolation inside the bracketing bucket (lower bound = previous
        bucket's upper bound, 0 or observed min for the first)."""
        if self.count == 0:
            return None
        target = p * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                if i == len(self.buckets):   # overflow bucket
                    return self.max
                hi = self.buckets[i]
                lo = self.buckets[i - 1] if i > 0 else min(self.min, hi)
                frac = (target - cum) / c
                est = lo + (hi - lo) * frac
                # exact bounds beat bucket edges at the extremes
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Named metric store + optional structured sink. ``event()`` both
    counts and (when a sink is attached) appends a structured JSONL record
    of a discrete occurrence."""

    def __init__(self, sink=None):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._sink = sink

    # ------------------------------------------------------------- factories
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name, buckets))
        return h

    # ----------------------------------------------------------------- sink
    def attach_sink(self, sink) -> None:
        self._sink = sink

    @property
    def sink(self):
        return self._sink

    def event(self, name: str, **fields) -> None:
        """Count a discrete occurrence; stream it when a sink is attached."""
        self.counter(name).inc()
        if self._sink is not None:
            try:
                self._sink.write({"kind": "event", "name": name, **fields})
            except Exception:  # telemetry must never take down the job
                pass

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                "counters": {k: c.snapshot() for k, c in self._counters.items()},
                "gauges": {k: g.snapshot() for k, g in self._gauges.items()
                           if g.value is not None},
                "histograms": {k: h.snapshot()
                               for k, h in self._histograms.items()},
            }

    def flush(self, step: Optional[int] = None) -> None:
        """Write a full snapshot record to the sink (no-op without one)."""
        if self._sink is None:
            return
        rec = {"kind": "snapshot", "metrics": self.snapshot()}
        if step is not None:
            rec["step"] = step
        try:
            self._sink.write(rec)
            self._sink.flush()
        except Exception:
            pass

    # ---------------------------------------------------------- prometheus
    def to_prometheus(self, prefix: str = "dstpu") -> str:
        """The live registry in the Prometheus text exposition format.
        Names are sanitized (``serving/ttft_ms`` ->
        ``dstpu_serving_ttft_ms``); counters gain the ``_total`` suffix;
        histograms emit the cumulative bucket series (+Inf included) plus
        ``_sum`` and ``_count``, so ``histogram_quantile`` sees the buckets
        the in-process percentiles use."""
        def san(name: str) -> str:
            return sanitize_metric_name(name, prefix)

        lines: List[str] = []
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        for c in sorted(counters, key=lambda m: m.name):
            n = san(c.name) + "_total"
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {c.value}")
        for g in sorted(gauges, key=lambda m: m.name):
            if g.value is None:
                continue
            n = san(g.name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {g.value}")
        for h in sorted(hists, key=lambda m: m.name):
            n = san(h.name)
            lines.append(f"# TYPE {n} histogram")
            cum = 0
            for bound, cnt in zip(h.buckets, h.counts):
                cum += cnt
                lines.append(f'{n}_bucket{{le="{bound}"}} {cum}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{n}_sum {h.sum}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# ---------------------------------------------------------------- global
_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry: engines default to it."""
    return _default_registry


def reset_registry() -> None:
    """Clear the global registry (tests / benchmark isolation). The
    attached sink, if any, is kept."""
    _default_registry.reset()


def record_event(name: str, **fields) -> None:
    """Fire-and-forget event into the global registry; exception-proof, so
    any subsystem can call it unconditionally."""
    try:
        _default_registry.event(name, **fields)
    except Exception:
        pass
