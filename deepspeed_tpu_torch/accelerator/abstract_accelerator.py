"""Accelerator interface of the PyTorch port (counterpart of
deepspeed_tpu/accelerator/abstract_accelerator.py, cut to what the
serving, training and telemetry paths use).

The card's peaks live here, in one table (:data:`CARD_PEAKS`), read by
``telemetry/mfu.py`` (the MFU denominator) and
``telemetry/attribution.py`` (the roofline's two roofs), with the
reference's overrides: ``DSTPU_PEAK_TFLOPS`` and ``DSTPU_PEAK_HBM_GBPS``
replace the table's entry for any device, the CPU included."""

from __future__ import annotations

import abc
import os
from typing import Dict, Optional, Tuple

import torch

# (dense bf16 tensor-core TFLOP/s, HBM GB/s) per card, by a substring of
# torch.cuda.get_device_name: the H100 SXM5 data sheet
CARD_PEAKS: Dict[str, Tuple[float, float]] = {
    "H100 80GB HBM3": (989.0, 3350.0),
    "H100 SXM": (989.0, 3350.0),
}


def _env_peak(var: str) -> Optional[float]:
    env = os.environ.get(var)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return None


def card_peaks(device_name: str) -> Tuple[Optional[float], Optional[float]]:
    """(TFLOP/s, GB/s) of a device by name: the overrides where set, else
    the table's entry, else None."""
    tf, bw = next((v for k, v in CARD_PEAKS.items() if k in device_name),
                  (None, None))
    env_tf = _env_peak("DSTPU_PEAK_TFLOPS")
    env_bw = _env_peak("DSTPU_PEAK_HBM_GBPS")
    return (env_tf if env_tf is not None else tf,
            env_bw if env_bw is not None else bw)


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

    def peak_tflops(self) -> Optional[float]:
        """Dense bf16 peak TFLOP/s of the device (the MFU denominator);
        None when unknown."""
        return card_peaks(self.device_name())[0]

    def peak_hbm_gbps(self) -> Optional[float]:
        """Peak memory bandwidth in GB/s (the roofline's memory roof);
        None when unknown."""
        return card_peaks(self.device_name())[1]

    def memory_stats(self) -> Dict[str, int]:
        """``bytes_in_use`` and ``peak_bytes_in_use`` of the device's
        allocator, the reference's keys; empty where there are none."""
        return {}

    def __repr__(self):
        return f"{type(self).__name__}({self.device()})"
