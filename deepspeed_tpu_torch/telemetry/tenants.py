"""Per-tenant usage and cost accounting of the port (port of
deepspeed_tpu/telemetry/tenants.py).

Requests of many callers share one KV store, one prefix cache and one
prefill budget; the ledger attributes what each tenant consumed:

* **token usage**: prompt tokens and decode (generated) tokens;
* **prefill economics**: prefill tokens computed against tokens saved by
  the radix prefix cache;
* **KV occupancy**: block-seconds (pool blocks held, integrated over the
  engine's clock) and byte-seconds at payload bytes, so a quantized
  pool's blocks bill at what they cost in memory;
* **QoS suffered**: preemptions, sheds, and per-tenant TTFT/TPOT
  histograms.

Everything is host dict arithmetic at call sites the serving engine
already owns (admission, the chunk loop, token commits, finish,
preemption): no device work, and the per-tenant token totals sum exactly
to the engine's counters.

Tenant ids are the callers' strings
(:attr:`~deepspeed_tpu_torch.serving.scheduler.Request.tenant_id`, default
:data:`DEFAULT_TENANT`), sanitized by
:func:`~deepspeed_tpu_torch.telemetry.registry.metric_label` (shared with
``sanitize_metric_name``) before they name registry metrics.
"""

from __future__ import annotations

from typing import Dict, Optional

from deepspeed_tpu_torch.telemetry.registry import (MetricsRegistry, metric_label)

DEFAULT_TENANT = "default"

# TTFT/TPOT per tenant reuse the registry's default latency buckets


class _TenantMetrics:
    """One tenant's registry handles + exact local accumulators. The
    registry handles are resolved ONCE per tenant (hot-path updates are
    then a bound-method call), under literal f-string metric names."""

    __slots__ = ("tenant", "requests", "prompt_tokens", "decode_tokens",
                 "prefill_tokens_computed", "prefill_tokens_saved",
                 "kv_block_seconds", "kv_byte_seconds", "preemptions",
                 "sheds", "ttft_ms", "tpot_ms")

    def __init__(self, tenant: str, reg: Optional[MetricsRegistry]):
        self.tenant = tenant
        t = tenant
        if reg is not None:
            self.requests = reg.counter(f"serving/tenant/{t}/requests")
            self.prompt_tokens = reg.counter(
                f"serving/tenant/{t}/prompt_tokens")
            self.decode_tokens = reg.counter(
                f"serving/tenant/{t}/decode_tokens")
            self.prefill_tokens_computed = reg.counter(
                f"serving/tenant/{t}/prefill_tokens_computed")
            self.prefill_tokens_saved = reg.counter(
                f"serving/tenant/{t}/prefill_tokens_saved")
            self.kv_block_seconds = reg.counter(
                f"serving/tenant/{t}/kv_block_seconds")
            self.kv_byte_seconds = reg.counter(
                f"serving/tenant/{t}/kv_byte_seconds")
            self.preemptions = reg.counter(
                f"serving/tenant/{t}/preemptions")
            self.sheds = reg.counter(f"serving/tenant/{t}/sheds")
            self.ttft_ms = reg.histogram(f"serving/tenant/{t}/ttft_ms")
            self.tpot_ms = reg.histogram(f"serving/tenant/{t}/tpot_ms")
        else:
            from deepspeed_tpu_torch.telemetry.registry import Counter, Histogram

            self.requests = Counter("requests")
            self.prompt_tokens = Counter("prompt_tokens")
            self.decode_tokens = Counter("decode_tokens")
            self.prefill_tokens_computed = Counter("prefill_tokens_computed")
            self.prefill_tokens_saved = Counter("prefill_tokens_saved")
            self.kv_block_seconds = Counter("kv_block_seconds")
            self.kv_byte_seconds = Counter("kv_byte_seconds")
            self.preemptions = Counter("preemptions")
            self.sheds = Counter("sheds")
            self.ttft_ms = Histogram("ttft_ms")
            self.tpot_ms = Histogram("tpot_ms")


class TenantLedger:
    """Per-tenant accounting over a metrics registry (or standalone,
    with private metric objects, when ``registry`` is None).

    The engine resolves a request's tenant ONCE at submit/admit
    (:meth:`resolve`) and hands the sanitized label to every later
    note; two raw ids that sanitize identically share a ledger row by
    design (the registry could not tell them apart either)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry
        self._tenants: Dict[str, _TenantMetrics] = {}

    # ------------------------------------------------------------- lookup
    @staticmethod
    def resolve(tenant_id) -> str:
        """Sanitized ledger key for a caller-supplied tenant id (None ->
        the default tenant)."""
        if tenant_id is None:
            return DEFAULT_TENANT
        return metric_label(tenant_id)

    def _m(self, tenant: str) -> _TenantMetrics:
        tm = self._tenants.get(tenant)
        if tm is None:
            tm = _TenantMetrics(tenant, self.registry)
            self._tenants[tenant] = tm
        return tm

    def tenants(self):
        return sorted(self._tenants)

    # -------------------------------------------------------------- notes
    def note_admitted(self, tenant: str, prompt_tokens: int) -> None:
        m = self._m(tenant)
        m.requests.inc()
        m.prompt_tokens.inc(int(prompt_tokens))

    def note_prefill(self, tenant: str, computed: int,
                     saved: int = 0) -> None:
        m = self._m(tenant)
        if computed:
            m.prefill_tokens_computed.inc(int(computed))
        if saved:
            m.prefill_tokens_saved.inc(int(saved))

    def note_tokens(self, tenant: str, n: int) -> None:
        if n:
            self._m(tenant).decode_tokens.inc(int(n))

    def note_kv_occupancy(self, tenant: str, blocks: int, dt: float,
                          payload_bytes_per_block: float) -> None:
        """Integrate pool occupancy: ``blocks`` held for ``dt`` seconds
        of engine-clock time. Byte-seconds bill at PAYLOAD bytes per
        block (scales included), so an int8 pool's blocks cost ~half a
        bf16 pool's — the capacity lever shows up in the bill."""
        if blocks <= 0 or dt <= 0:
            return
        m = self._m(tenant)
        m.kv_block_seconds.inc(blocks * dt)
        m.kv_byte_seconds.inc(blocks * dt * payload_bytes_per_block)

    def note_preemption(self, tenant: str) -> None:
        self._m(tenant).preemptions.inc()

    def note_shed(self, tenant: str) -> None:
        self._m(tenant).sheds.inc()

    def note_ttft(self, tenant: str, ms: float) -> None:
        self._m(tenant).ttft_ms.observe(ms)

    def note_tpot(self, tenant: str, ms: float) -> None:
        self._m(tenant).tpot_ms.observe(ms)

    # ------------------------------------------------------------- totals
    def totals(self) -> Dict[str, dict]:
        """Per-tenant usage snapshot (the report's ``tenants`` table
        source when no registry snapshot is available)."""
        out: Dict[str, dict] = {}
        for t in self.tenants():
            m = self._tenants[t]
            out[t] = {
                "requests": m.requests.value,
                "prompt_tokens": m.prompt_tokens.value,
                "decode_tokens": m.decode_tokens.value,
                "prefill_tokens_computed": m.prefill_tokens_computed.value,
                "prefill_tokens_saved": m.prefill_tokens_saved.value,
                "kv_block_seconds": round(float(m.kv_block_seconds.value), 6),
                "kv_byte_seconds": round(float(m.kv_byte_seconds.value), 3),
                "preemptions": m.preemptions.value,
                "sheds": m.sheds.value,
                "ttft_ms_p50": m.ttft_ms.percentile(0.5),
                "tpot_ms_p50": m.tpot_ms.percentile(0.5),
            }
        return out

    def __repr__(self):
        return f"TenantLedger(tenants={self.tenants()})"
