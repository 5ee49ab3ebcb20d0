"""Accelerator interface of the PyTorch port (counterpart of
deepspeed_tpu/accelerator/abstract_accelerator.py, cut to what the
serving path uses)."""

from __future__ import annotations

import abc

import torch


class DeviceUnavailableError(RuntimeError):
    """The requested device does not exist on this machine. The port never
    carries on quietly on another device: a caller that wants the CPU asks
    for it with ``device="cpu"``."""


class DeepSpeedAccelerator(abc.ABC):
    @abc.abstractmethod
    def device(self) -> torch.device: ...

    @abc.abstractmethod
    def device_name(self) -> str: ...

    @abc.abstractmethod
    def synchronize(self) -> None: ...

    def __repr__(self):
        return f"{type(self).__name__}({self.device()})"
