"""Model-flops utilization of the port (port of
deepspeed_tpu/telemetry/mfu.py), in the PaLM sense: achieved model
flops/sec over the card's peak.

The peak is the accelerator layer's (``accelerator.card_peaks``: the
card's dense bf16 tensor-core rate from its data sheet, looked up by
``torch.cuda.get_device_name``, 989 TFLOP/s for the H100 SXM;
``DSTPU_PEAK_TFLOPS`` overrides it); this module only does the division.
An unknown card (or no card, without the override) gives None.
"""

from __future__ import annotations

from typing import Optional

from deepspeed_tpu_torch.accelerator.abstract_accelerator import card_peaks


def peak_flops_per_sec(n_chips: Optional[int] = None,
                       device_name: Optional[str] = None) -> Optional[float]:
    """Aggregate peak (flops/sec) across ``n_chips`` cards (default: every
    visible card) named ``device_name`` (default: card 0's name, or "cpu"
    without a card). None when the peak is unknown."""
    import torch

    cuda = torch.cuda.is_available()
    if device_name is None:
        device_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    per_card = card_peaks(device_name)[0]
    if not per_card or per_card <= 0:
        return None
    if n_chips is None:
        n_chips = torch.cuda.device_count() if cuda else 1
    return per_card * 1e12 * max(n_chips, 1)


def mfu(flops_per_step: float, step_time_s: float,
        n_chips: Optional[int] = None,
        device_name: Optional[str] = None) -> Optional[float]:
    """Achieved-over-peak utilization in [0, ~1]; None when the peak is
    unknown or the inputs are degenerate."""
    if not flops_per_step or not step_time_s or step_time_s <= 0:
        return None
    peak = peak_flops_per_sec(n_chips, device_name)
    if peak is None:
        return None
    return (flops_per_step / step_time_s) / peak
