"""Wall-clock timers and throughput accounting of the port (port of
deepspeed_tpu/utils/timer.py, the analog of the reference's
``deepspeed/utils/timer.py``: SynchronizedWallClockTimer, ThroughputTimer).

On the card an interval is a pair of CUDA events recorded on the current
stream: it spans the device work queued between them, not only the host's
launches. A named timer's intervals are read when it is read (``elapsed``,
``mean``, ``log``), which synchronizes on the last end event, so timing a
step adds no host sync of its own until the timers are logged; the
throughput timer reads each interval when it stops. Without a card the
host clock times it.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from .logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


class _Interval:
    """One interval on CUDA events (``cuda``) or the host clock."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self._t0 = None

    def begin(self) -> None:
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def end_lazy(self):
        """Close the interval; its seconds come from :func:`_seconds` (on
        the card an event pair, read later without a sync here)."""
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            return (self._t0, t1)
        return time.perf_counter() - self._t0

    def end(self) -> float:
        """Seconds since :meth:`begin`."""
        return _seconds(self.end_lazy())


def _seconds(interval) -> float:
    """An interval's seconds: a host-clock float as is, a CUDA event pair
    once its end event has completed."""
    if isinstance(interval, float):
        return interval
    t0, t1 = interval
    t1.synchronize()
    return t0.elapsed_time(t1) / 1e3


def _use_cuda(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


class _Timer:
    def __init__(self, name: str, cuda: bool):
        self.name = name
        self.started = False
        self._interval = _Interval(cuda)
        self._elapsed = 0.0
        # closed intervals not read yet: (interval, recorded)
        self._pending: List[tuple] = []
        self._record: List[float] = []

    def start(self):
        assert not self.started, f"timer {self.name} already started"
        self._interval.begin()
        self.started = True

    def stop(self, record: bool = False):
        assert self.started, f"timer {self.name} not started"
        self._pending.append((self._interval.end_lazy(), record))
        self.started = False

    def _resolve(self) -> None:
        for interval, record in self._pending:
            dt = _seconds(interval)
            self._elapsed += dt
            if record:
                self._record.append(dt)
        self._pending.clear()

    def reset(self):
        self.started = False
        self._pending.clear()
        self._elapsed = 0.0

    def elapsed(self, reset: bool = True) -> float:
        started = self.started
        if started:
            self.stop()
        self._resolve()
        out = self._elapsed
        if reset:
            self.reset()
        if started:
            self.start()
        return out

    def mean(self) -> float:
        self._resolve()
        return sum(self._record) / max(len(self._record), 1)


class SynchronizedWallClockTimer:
    """Named timers on ``device`` (default: the card when there is one)."""

    def __init__(self, device=None):
        self.timers: "OrderedDict[str, _Timer]" = OrderedDict()
        self.cuda = _use_cuda(device)

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.cuda)
        return self.timers[name]

    def has(self, name: str) -> bool:
        return name in self.timers

    def memory_usage(self) -> str:
        if not self.cuda:
            return "Device mem: unavailable"
        in_use = torch.cuda.memory_allocated() / (1024 ** 3)
        peak = torch.cuda.max_memory_allocated() / (1024 ** 3)
        return f"Device mem: in_use {in_use:.2f} GB | peak {peak:.2f} GB"

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False, ranks: Optional[List[int]] = None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += f" | {name}: {elapsed:.2f}"
        if memory_breakdown:
            string += " | " + self.memory_usage()
        log_dist(string, ranks=ranks or [0])

    def get_mean(self, names: List[str], normalizer: float = 1.0) -> Dict[str, float]:
        return {n: self.timers[n].mean() * 1000.0 / normalizer
                for n in names if n in self.timers}


class ThroughputTimer:
    """Samples/sec and a TFLOP/s estimate over global steps, the
    reference's ThroughputTimer (deepspeed/utils/timer.py:137); steps
    before ``start_step`` are not timed."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: int = 50, monitor_memory: bool = False,
                 logging_fn=None, device=None):
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))
        self._interval = _Interval(_use_cuda(device))
        self.started = False
        self.timing = False
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self.window_steps = 0          # timed global steps in the window
        self.flops_per_sample = None   # set by the caller from a cost model

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self):
        self.started = True
        self.timing = self.global_step_count >= self.start_step
        if self.timing:
            self._interval.begin()

    def stop(self, global_step: bool = False, report_speed: bool = True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if not self.timing:
            return
        self.timing = False
        duration = self._interval.end()
        self.total_elapsed_time += duration
        self.step_elapsed_time += duration
        if global_step:
            self.window_steps += 1
        if (global_step and report_speed
                and self.global_step_count % self.steps_per_output == 0):
            window = self.batch_size * max(self.window_steps, 1)
            msg = (f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                   f"global_step={self.global_step_count}, "
                   f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.3f}, "
                   f"CurrSamplesPerSec={window / self.step_elapsed_time:.3f}")
            if self.flops_per_sample:
                tflops = (self.flops_per_sample * window
                          / self.step_elapsed_time / 1e12)
                msg += f", TFLOPs={tflops:.2f}"
            self.logging(msg)
            self.step_elapsed_time = 0.0
            self.window_steps = 0

    def avg_samples_per_sec(self) -> float:
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            samples = self.batch_size * (self.global_step_count - self.start_step)
            return samples / self.total_elapsed_time
        return float("nan")

