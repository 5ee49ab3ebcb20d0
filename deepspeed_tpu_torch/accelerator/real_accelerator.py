"""Accelerator selection for the PyTorch port.

``get_accelerator()`` (or ``get_accelerator("cuda")``) is the CUDA card and
raises :class:`DeviceUnavailableError` when there is none. The CPU
accelerator exists only for callers that ask for it by name (the CPU
tests); there is no auto-fallback."""

from __future__ import annotations

from typing import Optional, Union

import torch

from .abstract_accelerator import DeepSpeedAccelerator, DeviceUnavailableError


class CUDA_Accelerator(DeepSpeedAccelerator):
    def __init__(self, index: int = 0):
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        self.index = index

    def device(self) -> torch.device:
        return torch.device("cuda", self.index)

    def device_name(self) -> str:
        return torch.cuda.get_device_name(self.index)

    def synchronize(self) -> None:
        torch.cuda.synchronize(self.index)


class CPU_Accelerator(DeepSpeedAccelerator):
    def device(self) -> torch.device:
        return torch.device("cpu")

    def device_name(self) -> str:
        return "cpu"

    def synchronize(self) -> None:
        return None


def get_accelerator(device: Optional[Union[str, torch.device]] = None
                    ) -> DeepSpeedAccelerator:
    """The accelerator for ``device``: None or "cuda[:i]" -> the card,
    "cpu" -> the CPU. Anything else raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return CUDA_Accelerator(dev.index or 0)
    if dev.type == "cpu":
        return CPU_Accelerator()
    raise DeviceUnavailableError(f"unsupported device {device!r}")
