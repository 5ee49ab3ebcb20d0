"""Experiment monitoring (port of deepspeed_tpu/monitor/monitor.py) — analog
of reference ``deepspeed/monitor/`` (MonitorMaster monitor.py:29 fanning
out to the TensorBoard, W&B and csv writers, plus the JSONL writer).

Writers activate only on rank 0 (the port runs one rank: 0 unless a
``torch.distributed`` process group says otherwise) and disable themselves
with a warning when their backend package is absent (TensorBoard and W&B
are optional; csv and JSONL always work).
"""

from __future__ import annotations

import os
from typing import List, Tuple

from deepspeed_tpu_torch.utils.logging import logger

Event = Tuple[str, float, int]  # (tag, value, global_step)


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Monitor:
    def __init__(self, config):
        self.config = config
        self.enabled = False

    def write_events(self, event_list: List[Event]):
        raise NotImplementedError


class TensorBoardMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self.summary_writer = None
        if config.enabled and _rank() == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter

                log_dir = os.path.join(config.output_path or "./runs", config.job_name)
                self.summary_writer = SummaryWriter(log_dir=log_dir)
                self.enabled = True
            except Exception as e:  # tensorboard not installed
                logger.warning(f"TensorBoard monitor disabled: {e}")

    def write_events(self, event_list, flush: bool = True):
        if self.summary_writer is None:
            return
        for tag, value, step in event_list:
            self.summary_writer.add_scalar(tag, value, step)
        if flush:
            self.summary_writer.flush()


class WandbMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self._wandb = None
        if config.enabled and _rank() == 0:
            try:
                import wandb

                wandb.init(project=config.project, group=config.group or None,
                           entity=config.team or None)
                self._wandb = wandb
                self.enabled = True
            except Exception as e:
                logger.warning(f"W&B monitor disabled: {e}")

    def write_events(self, event_list):
        if self._wandb is None:
            return
        for tag, value, step in event_list:
            self._wandb.log({tag: value}, step=step)


class csvMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self.filenames: dict = {}
        if config.enabled and _rank() == 0:
            self.output_path = os.path.join(config.output_path or "./csv_logs",
                                            config.job_name)
            os.makedirs(self.output_path, exist_ok=True)
            self.enabled = True

    def write_events(self, event_list):
        if not self.enabled:
            return
        for tag, value, step in event_list:
            safe = tag.replace("/", "_")
            path = os.path.join(self.output_path, f"{safe}.csv")
            new = not os.path.exists(path)
            with open(path, "a") as f:
                if new:
                    f.write("step,value\n")
                f.write(f"{step},{value}\n")


class JsonlMonitor(Monitor):
    """Structured JSONL writer over the port's telemetry sink
    (telemetry/sink.py): scalar events append to
    ``<output_path>/<job_name>.jsonl``, one record per line."""

    def __init__(self, config):
        super().__init__(config)
        self.sink = None
        if config.enabled and _rank() == 0:
            from deepspeed_tpu_torch.telemetry.sink import JsonlSink

            path = os.path.join(config.output_path or "./telemetry",
                                f"{config.job_name}.jsonl")
            try:
                self.sink = JsonlSink(path)
                self.enabled = True
            except Exception as e:
                logger.warning(f"JSONL monitor disabled: {e}")

    def write_events(self, event_list):
        if self.sink is None:
            return
        for tag, value, step in event_list:
            self.sink.scalar(tag, float(value), int(step))
        self.sink.flush()


class MonitorMaster(Monitor):
    """Fans write_events out to every enabled writer (reference monitor.py:29)."""

    def __init__(self, config):
        super().__init__(config)
        self.tb_monitor = TensorBoardMonitor(config.tensorboard)
        self.wandb_monitor = WandbMonitor(config.wandb)
        self.csv_monitor = csvMonitor(config.csv_monitor)
        self.jsonl_monitor = JsonlMonitor(config.jsonl_monitor)
        self.enabled = (self.tb_monitor.enabled or self.wandb_monitor.enabled or
                        self.csv_monitor.enabled or self.jsonl_monitor.enabled)

    def write_events(self, event_list: List[Event]):
        if _rank() != 0:
            return
        for mon in (self.tb_monitor, self.wandb_monitor, self.csv_monitor,
                    self.jsonl_monitor):
            if mon.enabled:
                mon.write_events(event_list)
