"""Model-flops utilization of the port (port of
deepspeed_tpu/telemetry/mfu.py), in the PaLM sense: achieved model
flops/sec over the card's peak.

The peak is the card's dense bf16 tensor-core rate from its data sheet,
looked up by ``torch.cuda.get_device_name``: the H100 SXM's 989 TFLOP/s.
A card missing from the table (or no card) gives None.
"""

from __future__ import annotations

from typing import Optional

# dense bf16 tensor-core peak per card, TFLOP/s, by a substring of
# torch.cuda.get_device_name (H100 SXM5 data sheet)
PEAK_TFLOPS = {"H100 80GB HBM3": 989.0, "H100 SXM": 989.0}


def card_peak_tflops(device_name: str) -> Optional[float]:
    """The table's entry for a card name, or None."""
    for key, tflops in PEAK_TFLOPS.items():
        if key in device_name:
            return tflops
    return None


def peak_flops_per_sec(n_chips: Optional[int] = None,
                       device_name: Optional[str] = None) -> Optional[float]:
    """Aggregate peak (flops/sec) across ``n_chips`` cards (default: every
    visible card) named ``device_name`` (default: card 0's name). None when
    there is no card or its name is not in the table."""
    import torch

    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    per_card = card_peak_tflops(device_name)
    if per_card is None:
        return None
    if n_chips is None:
        n_chips = torch.cuda.device_count() if torch.cuda.is_available() else 1
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
