"""Reusable fault-injection harness for robustness tests (port of the
training seams of deepspeed_tpu/testing/fault_injection.py).

All checkpoint bytes flow through the seam functions in
``deepspeed_tpu_torch.utils.fs`` (``read_bytes`` / ``write_bytes`` /
``stream_write`` / ``replace``), so :class:`FaultInjector` can
deterministically inject the failure modes that matter for fault
tolerance — truncated writes, I/O errors on the Nth call, slow writes, and
simulated worker crashes mid-operation — without subprocesses.

The training seams corrupt what a run sees: :func:`poison_sample` /
:class:`PoisonedDataset` (a corrupt data shard), :func:`flip_param_bit`
(one card's memory bit flip in a parameter) and :func:`corrupt_file` (bit
rot in a published checkpoint). For the elasticity layer,
:class:`FakeClock` and :class:`ScriptedWorkerGroup` drive
:class:`~deepspeed_tpu_torch.elasticity.elastic_agent.ElasticAgent`
through arbitrary failure/preemption schedules in virtual time.

For the serving fabric, the injector grows replica seams:
:meth:`FaultInjector.replica_plan` returns a per-replica
:class:`ReplicaFaultPlan` that an
:class:`~deepspeed_tpu_torch.serving.fabric.replica.InProcessReplica`
consults on every step and probe — a scripted crash on the Nth step,
slow-replica straggling (virtual-time stalls), flaky steps and failing
health probes — and :meth:`FaultInjector.alert_storm` scripts synthetic
SLO alert transitions (:class:`AlertStormPlan`), so a multi-replica chaos
run stays in-process, in virtual time.

Usage::

    with FaultInjector() as inj:
        inj.truncate_write(nth=1, keep_bytes=64)   # crash mid state.npz
        with pytest.raises(SimulatedCrash):
            engine.save_checkpoint(ckpt_dir)
    # seam functions restored here
"""

from __future__ import annotations

import time as _time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.utils import fs
from deepspeed_tpu_torch.utils.tree import tree_leaves


class SimulatedCrash(BaseException):
    """Models a worker dying mid-operation (SIGKILL / preemption without
    grace). Derives from ``BaseException`` so generic ``except Exception``
    recovery paths cannot accidentally 'survive' the kill — exactly like a
    real dead process."""


class FaultInjector:
    """Patches ``deepspeed_tpu_torch.utils.fs`` primitives; restores them on
    ``__exit__`` / ``restore()``. Call counters (``write_calls``,
    ``read_calls``, ``replace_calls``) count *entries*, including calls that
    fault, so Nth-call targeting is deterministic under retries."""

    def __init__(self, target=fs):
        self.target = target
        self.write_calls = 0
        self.read_calls = 0
        self.replace_calls = 0
        self._saved = {}
        # serving-fabric seams: replica name -> fault plan, consulted by
        # InProcessReplica on every step/probe. Plans are plain scripted
        # state, not monkey-patches, so restore() does not apply — they
        # die with the injector.
        self._replica_plans: Dict[str, "ReplicaFaultPlan"] = {}
        # alert-storm seams: scripted synthetic SLO alert transitions,
        # drained by the twin into SLOEngine.inject_alert
        self._alert_storms: List["AlertStormPlan"] = []

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "FaultInjector":
        return self

    def __exit__(self, *exc):
        self.restore()
        return False

    def _original(self, name: str):
        return self._saved.get(name, getattr(self.target, name))

    def _patch(self, name: str, value):
        if name not in self._saved:
            self._saved[name] = getattr(self.target, name)
        setattr(self.target, name, value)

    def restore(self):
        for name, value in self._saved.items():
            setattr(self.target, name, value)
        self._saved.clear()

    # ------------------------------------------------------------- helpers
    def fast_retries(self):
        """Zero out retry backoff so exhausting the retry budget is
        instant — keeps fault tests fast without changing retry counts."""
        self._patch("DEFAULT_BASE_DELAY_S", 0.0)
        self._patch("DEFAULT_MAX_DELAY_S", 0.0)

    def _buffer_stream(self, writer) -> bytes:
        """Materialize a stream_write payload so byte-level faults (e.g.
        truncation) can apply to streamed writers exactly as to byte writes."""
        import io as _io

        buf = _io.BytesIO()
        writer(buf)
        return buf.getvalue()

    # -------------------------------------------------------------- faults
    def fail_writes(self, nth: int = 1, count: int = 1,
                    exc_factory: Optional[Callable[[], BaseException]] = None):
        """Raise on write calls ``nth .. nth+count-1`` (1-based, counting
        byte AND streamed writes together); other calls pass through.
        Default exception is a retryable ``OSError`` — use ``count`` > the
        retry budget to defeat the retry wrapper."""
        exc_factory = exc_factory or (lambda: OSError("injected I/O error"))
        real_wb = self._original("write_bytes")
        real_sw = self._original("stream_write")

        def _faulted(go):
            self.write_calls += 1
            if nth <= self.write_calls < nth + count:
                raise exc_factory()
            return go()

        self._patch("write_bytes", lambda path, data: _faulted(
            lambda: real_wb(path, data)))
        self._patch("stream_write", lambda path, writer: _faulted(
            lambda: real_sw(path, writer)))

    def truncate_write(self, nth: int = 1, keep_bytes: int = 64,
                       crash: bool = True):
        """The ``nth`` write persists only ``keep_bytes``. ``crash=True``
        raises :class:`SimulatedCrash` after the partial write (process
        died mid-write); ``crash=False`` returns as if successful — a torn
        write the checksum manifest must catch at load time."""
        real_wb = self._original("write_bytes")
        real_sw = self._original("stream_write")

        def _truncated(path, data, go):
            self.write_calls += 1
            if self.write_calls == nth:
                real_wb(path, bytes(data()[:keep_bytes]))
                if crash:
                    raise SimulatedCrash(f"simulated crash mid-write of {path}")
                return
            return go()

        self._patch("write_bytes", lambda path, data: _truncated(
            path, lambda: data, lambda: real_wb(path, data)))
        self._patch("stream_write", lambda path, writer: _truncated(
            path, lambda: self._buffer_stream(writer),
            lambda: real_sw(path, writer)))

    def slow_writes(self, delay_s: float,
                    sleep_fn: Callable[[float], None] = _time.sleep):
        """Every write sleeps ``delay_s`` first (stalling filesystem)."""
        real_wb = self._original("write_bytes")
        real_sw = self._original("stream_write")

        def _slowed(go):
            self.write_calls += 1
            sleep_fn(delay_s)
            return go()

        self._patch("write_bytes", lambda path, data: _slowed(
            lambda: real_wb(path, data)))
        self._patch("stream_write", lambda path, writer: _slowed(
            lambda: real_sw(path, writer)))

    def fail_reads(self, nth: int = 1, count: int = 1,
                   exc_factory: Optional[Callable[[], BaseException]] = None):
        exc_factory = exc_factory or (lambda: OSError("injected read error"))
        real = self._original("read_bytes")

        def read_bytes(path):
            self.read_calls += 1
            if nth <= self.read_calls < nth + count:
                raise exc_factory()
            return real(path)

        self._patch("read_bytes", read_bytes)

    # ----------------------------------------------------- serving seams
    def replica_plan(self, name: str) -> "ReplicaFaultPlan":
        """Fault plan for replica ``name`` (created on first access).
        Hand it to ``InProcessReplica(chaos=...)``; the scripting
        helpers below mutate the same plan by name."""
        return self._replica_plans.setdefault(name, ReplicaFaultPlan(name))

    def crash_replica_step(self, name: str, nth: int):
        """Replica ``name`` dies entering its ``nth`` step (1-based,
        counting from when the plan attaches): models a replica process
        SIGKILLed mid-trace — the router must fail its in-flight
        requests over to a survivor."""
        self.replica_plan(name).crash_at_step = nth

    def flaky_replica_step(self, name: str, nth: int, count: int = 1):
        """Steps ``nth .. nth+count-1`` of replica ``name`` raise a
        retryable transient error (the replica stays alive): repeated
        transients should trip the router's circuit breaker."""
        plan = self.replica_plan(name)
        plan.flaky_steps.update(range(nth, nth + count))

    def straggle_replica(self, name: str, delay_s: float, *,
                         from_step: int = 1, until_step: Optional[int] = None):
        """Replica ``name`` becomes a straggler: every step in
        ``[from_step, until_step]`` stalls the (virtual) clock by
        ``delay_s`` — the slow-host shape that blows per-request
        deadlines without any crash."""
        plan = self.replica_plan(name)
        plan.slow_from, plan.slow_until = from_step, until_step
        plan.slow_delay_s = delay_s

    def fail_replica_probes(self, name: str, count: int = 1):
        """The next ``count`` health probes of replica ``name`` raise a
        transient error (probe timeout / connection refused) while
        steps keep working — health-check flap the breaker must absorb
        or act on."""
        self.replica_plan(name).failing_probes += count

    # ------------------------------------------------------- alert seams
    def alert_storm(self, *, start_s: float, count: int = 10,
                    period_s: float = 0.1, severity: str = "page",
                    rule: str = "injected:storm", sli: str = "availability",
                    flap: bool = True) -> "AlertStormPlan":
        """Script a storm of SYNTHETIC SLO alert transitions: ``count``
        fires starting at ``start_s``, one per ``period_s``; with
        ``flap=True`` each fire resolves half a period later — the
        pathological flapping shape an autoscaler's hysteresis and
        cooldowns must absorb without thrashing the pool. The twin
        drains :meth:`due_alerts` each iteration into
        ``SLOEngine.inject_alert``, which fans the alerts to every
        subscriber through the real emit path without perturbing the
        burn-rate state machine."""
        plan = AlertStormPlan(start_s=start_s, count=count,
                              period_s=period_s, severity=severity,
                              rule=rule, sli=sli, flap=flap)
        self._alert_storms.append(plan)
        return plan

    def due_alerts(self, now: float) -> List:
        """Pop every scripted alert transition due at/before ``now``
        (across all storms), in time order."""
        out = []
        for plan in self._alert_storms:
            out.extend(plan.pop_due(now))
        out.sort(key=lambda a: a.t)
        return out

    def crash_on_replace(self, nth: int = 1):
        """Process dies at the publish step: the tmp file is complete but
        the atomic rename never happens — the prior version must survive."""
        real = self._original("replace")

        def replace(src, dst):
            self.replace_calls += 1
            if self.replace_calls == nth:
                raise SimulatedCrash(f"simulated crash before publishing {dst}")
            return real(src, dst)

        self._patch("replace", replace)


# ---------------------------------------------------------- training seams
def poison_sample(sample, mode: str):
    """Corrupt one dataset sample: ``"nan"`` fills float leaves with NaN
    (nonfinite loss/grads — what the finite-grad guard must catch);
    ``"huge"`` scales float leaves by 1e6 (finite but enormous loss — the
    robust z-score spike shape). Integer leaves (token ids) pass through."""

    def corrupt(node):
        if isinstance(node, dict):
            return {k: corrupt(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(corrupt(v) for v in node)
        arr = np.asarray(node)
        if arr.dtype.kind != "f":
            return node
        if mode == "nan":
            return np.full_like(arr, np.nan)
        if mode == "huge":
            return arr * np.asarray(1e6, arr.dtype)
        raise ValueError(f"unknown poison mode {mode!r}")

    return corrupt(sample)


class PoisonedDataset:
    """Indexable-dataset wrapper with per-index poison: models a corrupt
    data shard. ``poison`` maps dataset index -> mode ("nan" | "huge").
    The wrapped dataset is untouched, so the SAME underlying data drives
    the clean-run side of a bit-identity comparison."""

    def __init__(self, dataset, poison: Dict[int, str]):
        self.dataset = dataset
        self.poison = dict(poison)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        sample = self.dataset[i]
        mode = self.poison.get(int(i))
        if mode is None:
            return sample
        return poison_sample(sample, mode)


def flip_param_bit(engine, device_index: int = 0, leaf_index: int = 0,
                   byte: int = 0, bit: int = 0):
    """Flip one bit in one device's copy of one parameter — the silent
    data corruption model (a card's memory bit flip). The port trains on
    one device, which holds the one copy of every leaf: the flip is made
    in place in that copy, and any ``device_index`` but 0 raises. Leaves
    are counted in the parameter tree's sorted-key order (the JAX
    package's); ``byte`` indexes the leaf's bytes in memory order.
    Returns the flipped leaf's index."""
    if device_index != 0:
        raise ValueError(
            f"flip_param_bit: device_index {device_index}, but the engine "
            f"holds its parameters on one device (index 0)")
    leaves = tree_leaves(engine.state.params)
    idx = leaf_index % len(leaves)
    leaf = leaves[idx]
    if not leaf.is_contiguous():
        raise ValueError("flip_param_bit needs a contiguous parameter")
    with torch.no_grad():
        flat = leaf.view(-1).view(torch.uint8)
        pos = byte % flat.numel()
        flat[pos:pos + 1].bitwise_xor_(1 << (bit % 8))
    return idx


def corrupt_file(path, keep_bytes: int = 64):
    """Truncate a file in place — bit-rot / torn-write damage to an
    already-published artifact (e.g. a checkpoint tag corrupted AFTER its
    save succeeded, the mid-recovery chaos case: the rewind walk-back
    must skip it and fall to an older valid tag). Fails loudly when the
    file is already smaller than ``keep_bytes`` — a chaos seam that
    injects nothing makes its test pass vacuously."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) <= keep_bytes:
        raise ValueError(
            f"corrupt_file({path!r}): file is {len(raw)} bytes <= "
            f"keep_bytes={keep_bytes}; truncation would be a no-op")
    with open(path, "wb") as f:
        f.write(raw[:keep_bytes])


class ReplicaFaultPlan:
    """Scripted fault schedule for one serving replica.

    ``InProcessReplica`` calls :meth:`on_step` entering every engine
    step and :meth:`on_probe` on every health probe; the plan raises
    the typed serving errors the fabric's failure model is written
    against — :class:`SimulatedCrash` for process death (the replica
    wrapper converts it to a terminal ``ReplicaCrashedError``) and
    ``TransientReplicaError`` for retryable flap. Slow-straggler steps
    stall the caller's virtual clock (any object with ``advance``), so
    "this replica is 100x slower" is expressible without wall time.
    """

    def __init__(self, name: str):
        self.name = name
        self.crash_at_step: Optional[int] = None
        self.flaky_steps: set = set()
        self.slow_from: int = 0
        self.slow_until: Optional[int] = None
        self.slow_delay_s: float = 0.0
        self.failing_probes: int = 0
        self.step_calls = 0
        self.probe_calls = 0

    def on_step(self, clock=None) -> None:
        from deepspeed_tpu_torch.serving.errors import TransientReplicaError

        self.step_calls += 1
        n = self.step_calls
        if self.crash_at_step is not None and n >= self.crash_at_step:
            # one-shot: a crash kills ONE process; a resurrected replica
            # re-attaching the same plan starts clean (script another
            # crash with crash_replica_step again if the schedule says so)
            self.crash_at_step = None
            raise SimulatedCrash(
                f"replica {self.name}: scripted crash at step {n}")
        if (self.slow_delay_s and n >= self.slow_from
                and (self.slow_until is None or n <= self.slow_until)):
            advance = getattr(clock, "advance", None)
            if advance is not None:
                advance(self.slow_delay_s)
        if n in self.flaky_steps:
            raise TransientReplicaError(
                f"replica {self.name}: scripted flaky step {n}")

    def on_probe(self) -> None:
        from deepspeed_tpu_torch.serving.errors import TransientReplicaError

        self.probe_calls += 1
        if self.failing_probes > 0:
            self.failing_probes -= 1
            raise TransientReplicaError(
                f"replica {self.name}: scripted probe failure "
                f"#{self.probe_calls}")


class AlertStormPlan:
    """Scripted synthetic-alert schedule: a deterministic sequence of
    ``(t, "fired"/"resolved")`` transitions for one rule name. Builds
    real :class:`~deepspeed_tpu_torch.telemetry.slo.SLOAlert` objects
    lazily (keeps this module import-light)."""

    def __init__(self, *, start_s: float, count: int, period_s: float,
                 severity: str, rule: str, sli: str, flap: bool):
        self.rule = rule
        self.sli = sli
        self.severity = severity
        self.delivered = 0
        self._schedule: List = []   # (t, transition) pending, time-ordered
        for i in range(count):
            t = start_s + i * period_s
            self._schedule.append((t, "fired"))
            if flap:
                self._schedule.append((t + period_s / 2.0, "resolved"))
        self._schedule.sort(key=lambda x: x[0])

    def pop_due(self, now: float) -> List:
        from deepspeed_tpu_torch.telemetry.slo import SLOAlert

        out = []
        while self._schedule and self._schedule[0][0] <= now:
            t, transition = self._schedule.pop(0)
            self.delivered += 1
            out.append(SLOAlert(
                rule=self.rule, sli=self.sli, severity=self.severity,
                kind=transition, t=t, burn_short=99.0, burn_long=99.0,
                budget_consumed=1.0))
        return out


class FakeClock:
    """Deterministic virtual clock for ElasticAgent / serving-fabric
    tests: pass ``.time`` as ``time_fn`` and ``.sleep`` as ``sleep_fn``.
    ``auto_dt`` > 0 advances the clock by that much per ``time()`` READ
    — the serving engines poll the clock once per iteration, so an
    auto-advancing clock replays arrival traces deterministically
    without anyone calling ``advance`` (the fabric chaos suite's
    mode)."""

    def __init__(self, start: float = 0.0, auto_dt: float = 0.0):
        self.now = start
        self.auto_dt = auto_dt
        self.sleeps: List[float] = []

    def time(self) -> float:
        self.now += self.auto_dt
        return self.now

    def sleep(self, seconds: float):
        self.sleeps.append(seconds)
        self.now += seconds

    def advance(self, seconds: float):
        self.now += seconds


class ScriptedWorkerGroup:
    """A ``spawn_fn``/``monitor_fn`` pair whose worker groups exit with a
    scripted sequence of codes (the last one repeats). ``run_time_s``
    advances ``clock`` per monitored round, modelling how long the group
    lived — what the rolling restart-budget window keys on."""

    def __init__(self, exit_codes: Sequence[int],
                 clock: Optional[FakeClock] = None, run_time_s: float = 0.0):
        self.exit_codes = list(exit_codes)
        self.clock = clock
        self.run_time_s = run_time_s
        self.spawns = 0

    def spawn(self) -> List[str]:
        self.spawns += 1
        return [f"worker-group-{self.spawns}"]

    def monitor(self, procs) -> int:
        if self.clock is not None and self.run_time_s:
            self.clock.advance(self.run_time_s)
        return self.exit_codes[min(self.spawns - 1, len(self.exit_codes) - 1)]
