"""Preemption-aware shutdown: final checkpoint, then a restartable exit
(port of deepspeed_tpu/elasticity/preemption.py).

Cloud GPU VMs receive a maintenance/preemption notice as SIGTERM (and
Cloud exposes upcoming maintenance events that a poller can turn into the
same callback). :class:`PreemptionHandler` converts that notice into a final
*synchronous* checkpoint and an exit with :data:`PREEMPTION_EXIT_CODE` — a
code the :class:`~deepspeed_tpu_torch.elasticity.elastic_agent.ElasticAgent`
treats as always-restartable and exempt from the restart budget, because a
preempted worker is infrastructure churn, not a failing job.

Reference analog: torchelastic's graceful-shutdown path in
``DSElasticAgent`` (elasticity/elastic_agent.py:28); here the checkpoint
hook is explicit, as in the JAX package.
"""

from __future__ import annotations

import signal
import sys
from typing import Callable, Iterable, Optional

from deepspeed_tpu_torch.utils.logging import logger

# Distinct from shell conventions (126/127), signal deaths (128+n), and the
# job's own error codes — the elastic agent restarts it without burning the
# restart budget.
PREEMPTION_EXIT_CODE = 101


class PreemptionHandler:
    """Run a final synchronous checkpoint on preemption, then exit restartable.

    Usable three ways: ``install()`` as a SIGTERM hook, as a context manager
    (restores prior handlers on exit), or ``trigger()`` called directly from
    a maintenance-event poller. Re-entrant triggers are ignored — the
    first notice wins and later signals must not corrupt the in-flight final
    save.
    """

    def __init__(self, checkpoint_fn: Callable[[], None],
                 signals: Iterable[int] = (signal.SIGTERM,),
                 exit_code: int = PREEMPTION_EXIT_CODE,
                 exit_fn: Optional[Callable[[int], None]] = None,
                 defer: bool = False,
                 consensus_fn: Optional[Callable[[bool], bool]] = None,
                 busy_fn: Optional[Callable[[], bool]] = None):
        self.checkpoint_fn = checkpoint_fn
        self.signals = tuple(signals)
        self.exit_code = exit_code
        self.exit_fn = exit_fn if exit_fn is not None else sys.exit
        # consensus_fn(local_flag) -> global decision. On multi-host every
        # process must call it every poll (it is a collective): SIGTERMs
        # land at different instants on different hosts, and the final
        # save's gathers are only safe once ALL hosts agree to stop —
        # otherwise one host enters save collectives while a peer is still
        # launching step collectives, and both hang past the grace window.
        self.consensus_fn = consensus_fn
        # defer=True: the notice only sets ``preempted``; the final
        # checkpoint runs at the next ``poll()`` — REQUIRED on multi-host,
        # where checkpointing issues collectives (gathers) that
        # must not interleave with in-flight step collectives at an
        # arbitrary signal-interrupt point. Poll at step boundaries
        # (DeepSpeedEngine does this automatically).
        self.defer = defer
        # busy_fn() -> True while the caller's state is mid-update (a
        # training step updates parameters and moments in place, leaf by
        # leaf): a notice that lands then is deferred to the next poll()
        # even with defer=False, so the final save never captures a torn
        # state
        self.busy_fn = busy_fn
        self.preempted = False
        self._handled = False
        self._prev_handlers = {}

    def install(self) -> "PreemptionHandler":
        for sig in self.signals:
            self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self):
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def _on_signal(self, signum, frame):
        self.trigger(reason=f"signal {signal.Signals(signum).name}")

    def trigger(self, reason: str = "maintenance event"):
        """Preemption notice: checkpoint synchronously (best-effort — an
        exit with unsaved progress still beats hanging past the grace
        window), then exit with the restartable code. With ``defer=True``,
        or while ``busy_fn()`` is true, only the flag is set; the work
        happens at the next ``poll()``."""
        if self.preempted:
            logger.warning(f"preemption: re-entrant notice ({reason}) ignored; "
                           f"final checkpoint already in flight")
            return
        self.preempted = True
        if self.defer or (self.busy_fn is not None and self.busy_fn()):
            logger.warning(f"preemption notice ({reason}): final checkpoint "
                           f"deferred to the next step boundary")
            return
        self._finalize(reason)

    def poll(self):
        """Step-boundary check for deferred mode: runs the final checkpoint
        + restartable exit iff a preemption notice arrived (anywhere, when a
        ``consensus_fn`` is configured). Call it every training step — with
        a consensus collective configured, every host MUST call it every
        step regardless of its local flag."""
        if self._handled:
            return
        flag = self.preempted
        if self.consensus_fn is not None:
            flag = bool(self.consensus_fn(flag))
            if flag and not self.preempted:
                logger.warning("preemption: a peer host was preempted; "
                               "joining the coordinated final checkpoint")
                self.preempted = True
        if flag:
            self._finalize("deferred notice")

    def _finalize(self, reason: str):
        from deepspeed_tpu_torch.telemetry import record_event

        self._handled = True
        logger.warning(f"preemption notice ({reason}): writing final checkpoint")
        try:
            self.checkpoint_fn()
            record_event("elastic/preemption_saves", reason=reason)
            logger.warning(f"preemption: final checkpoint done; exiting with "
                           f"restartable code {self.exit_code}")
        except BaseException:
            record_event("elastic/preemption_save_failures", reason=reason)
            logger.exception("preemption: final checkpoint failed; exiting "
                             "restartable anyway (prior checkpoint stands)")
        self.exit_fn(self.exit_code)
