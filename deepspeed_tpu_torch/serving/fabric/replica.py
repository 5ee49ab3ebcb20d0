"""Replica abstraction for the multi-replica serving fabric (port of
deepspeed_tpu/serving/fabric/replica.py).

A :class:`Replica` is the router's unit of dispatch, health, and fault
isolation: it accepts requests, advances one serving iteration at a
time, answers health probes, and can cancel in-flight work. The fabric
ships ONE implementation — :class:`InProcessReplica`, a thin shell
around a :class:`~deepspeed_tpu_torch.serving.engine.ServingEngine` —
which is both the test vehicle (everything runs in-process, in virtual
time, following the ``ScriptedWorkerGroup``/``FakeClock`` pattern of
testing/fault_injection.py) and the seam where a multi-host transport
plugs in: the router only ever speaks this interface.

Failure model: a replica is either ALIVE or CRASHED. Crash is
terminal — every method raises
:class:`~deepspeed_tpu_torch.serving.errors.ReplicaCrashedError`
afterwards, exactly like RPCs against a dead process, and recovery means
the supervisor building a FRESH replica (new KV store and decode graphs
over the same shared InferenceEngine). Transient hiccups (flaky step,
failed probe) raise
:class:`~deepspeed_tpu_torch.serving.errors.TransientReplicaError` and
leave the replica alive. The chaos seams
(:class:`~deepspeed_tpu_torch.testing.fault_injection.ReplicaFaultPlan`)
inject both, scripted per step, in virtual time. Only those two typed
errors model a replica's failure: an error of the device or of a CUDA
graph capture inside the engine's step propagates as it is.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from deepspeed_tpu_torch.serving.errors import ReplicaCrashedError
from deepspeed_tpu_torch.serving.scheduler import Request, RequestResult
from deepspeed_tpu_torch.testing.fault_injection import (ReplicaFaultPlan,
                                                         SimulatedCrash)


@dataclasses.dataclass
class ReplicaHealth:
    """One heartbeat's worth of placement signal (the serving telemetry
    quantities the router's least-loaded policy reads): queue depth,
    free slots, free KV blocks (block-paged mode only), and total
    unfinished requests."""

    name: str
    queue_depth: int
    free_slots: int
    pending: int
    free_blocks: Optional[int] = None

    @property
    def load(self) -> float:
        """Scalar placement load: unfinished requests, fractionally
        discounted by free capacity so two equally-pending replicas
        tie-break toward the one with more open slots."""
        return self.pending - 1e-3 * self.free_slots


class Replica:
    """Interface the router dispatches against (duck-typed; this base
    only documents and raises)."""

    name: str = "?"

    def warmup(self) -> None:
        raise NotImplementedError

    def submit(self, request: Request) -> None:
        raise NotImplementedError

    def step(self, now: float) -> List[RequestResult]:
        raise NotImplementedError

    def probe(self, now: float) -> ReplicaHealth:
        raise NotImplementedError

    def cancel(self, rid: int) -> bool:
        raise NotImplementedError

    def recompile_count(self) -> int:
        raise NotImplementedError

    def release(self) -> None:
        """Free what the replica holds once the router retires it (by
        default nothing: a remote replica's process goes with it)."""

    @property
    def pending(self) -> int:
        """Unfinished requests on this replica (queued + in slots) —
        the router's cheap placement signal between heartbeats."""
        raise NotImplementedError


class InProcessReplica(Replica):
    """A :class:`ServingEngine` behind the :class:`Replica` interface.

    Parameters
    ----------
    name: stable identity (supervisor budgets and telemetry gauges key
        on it; a resurrected replica keeps the name of the one it
        replaces).
    serving: the wrapped ServingEngine. Replicas typically share one
        underlying ``InferenceEngine`` (its weights and programs). Each
        ServingEngine owns its KV store and the decode step's CUDA graph
        over it (captured at warm-up into the inference engine's one
        graph pool), so every replica captures its own graph; the
        zero-recompile invariant holds per replica all the same: one
        entry per program.
    chaos: optional scripted fault plan
        (``FaultInjector.replica_plan(name)``) consulted entering every
        step and probe.
    clock: optional virtual clock (an object with ``advance``) the
        chaos plan's slow-straggler faults stall; with a real clock
        straggling is not simulated (leave None).

    A crashed replica drops its ServingEngine (the dead process's card
    memory: KV store, decode graphs, pinned swap buffers), keeping only
    its recompile and decode-step counts; :meth:`release` does the same
    for a replica the router retires.
    """

    def __init__(self, name: str, serving, *,
                 chaos: Optional[ReplicaFaultPlan] = None, clock=None):
        self.name = name
        self.serving = serving
        self.chaos = chaos
        self._clock = clock
        self.alive = True
        self.steps = 0
        self._recompiles = 0
        self._decode_steps = 0

    # ------------------------------------------------------------ lifecycle
    def _check_alive(self) -> None:
        if not self.alive:
            raise ReplicaCrashedError(f"replica {self.name} is dead")

    def release(self) -> None:
        """Drop the wrapped engine, keeping its counts: its KV
        store and graphs go with the last reference to it."""
        if self.serving is not None:
            self._recompiles = self.serving.recompile_count()
            self._decode_steps = self.serving.decode_steps
            self.serving = None

    def warmup(self) -> None:
        self._check_alive()
        self.serving.warmup()

    # -------------------------------------------------------------- serving
    def submit(self, request: Request) -> None:
        self._check_alive()
        self.serving.submit(request)

    def step(self, now: float) -> List[RequestResult]:
        self._check_alive()
        if self.chaos is not None:
            try:
                self.chaos.on_step(self._clock)
            except SimulatedCrash as e:
                # process death: terminal — the engine's host state
                # (slots, queues, KV) is unreachable from here on, the
                # router must fail over from ITS OWN committed-token
                # record, never from anything of ours
                self.alive = False
                self.release()
                raise ReplicaCrashedError(str(e)) from e
            # TransientReplicaError propagates as-is: replica alive,
            # this iteration just didn't happen
        self.steps += 1
        return self.serving.step(now)

    def probe(self, now: float) -> ReplicaHealth:
        """Heartbeat: host-side scheduler reads and the block pool's free
        count, no device work or sync — safe at any probe frequency."""
        self._check_alive()
        if self.chaos is not None:
            self.chaos.on_probe()
        eng = self.serving
        free_blocks = None
        if eng.prefix is not None:
            # a property of the pool (the reference calls it, which
            # raises on a block-paged replica)
            free_blocks = eng.cache.free_count
        return ReplicaHealth(
            name=self.name, queue_depth=eng.scheduler.waiting,
            free_slots=eng.scheduler.free_slots, pending=eng.pending,
            free_blocks=free_blocks)

    def cancel(self, rid: int) -> bool:
        self._check_alive()
        return self.serving.cancel(rid)

    def recompile_count(self) -> int:
        if self.serving is None:
            return self._recompiles
        return self.serving.recompile_count()

    @property
    def decode_steps(self) -> int:
        """Decode steps the wrapped engine ran, kept past a release."""
        if self.serving is None:
            return self._decode_steps
        return self.serving.decode_steps

    @property
    def pending(self) -> int:
        return self.serving.pending if self.alive else 0

    def __repr__(self):
        return (f"InProcessReplica({self.name}, alive={self.alive}, "
                f"steps={self.steps})")
