"""Progressive Layer Drop (port of deepspeed_tpu/runtime/progressive_layer_drop.py;
reference ``deepspeed/runtime/progressive_layer_drop.py``): anneal a global
keep probability theta(t) from 1 toward ``theta`` on an exponential
schedule, and spread per-layer keep probabilities so that deeper layers
drop more — stochastic depth that speeds up pretraining.

The engine updates the schedule each step (``update_state(global_step)``)
and passes ``get_theta()`` to ``model.apply(pld_theta=...)``; the model
gates each block as ``x + keep / p_keep * (block(x) - x)`` when training
(identity at eval). Every block is computed and a dropped one is gated to
zero, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch


class ProgressiveLayerDrop:
    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_state(self) -> Dict:
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> float:
        """theta(t) = (1 - theta_bar) * exp(-gamma t) + theta_bar."""

        def _prob(x, gamma, p):
            return (1.0 - p) * math.exp(-gamma * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
        return self.current_theta


def layer_keep_probs(num_layers: int, theta: float) -> np.ndarray:
    """Per-layer keep probability: linear from 1 (first layer) to theta
    (last), the PLD paper's depth schedule."""
    if num_layers == 1:
        return np.array([theta])
    frac = np.arange(num_layers) / (num_layers - 1)
    return 1.0 - frac * (1.0 - theta)


def sample_layer_mask(generator: Optional[torch.Generator], num_layers: int,
                      theta: float, device=None):
    """Bernoulli keep mask ``[L]`` (bool) and the keep probabilities (f32),
    drawn from ``generator`` on ``device``."""
    probs = torch.as_tensor(layer_keep_probs(num_layers, theta),
                            dtype=torch.float32, device=device)
    keep = torch.rand(probs.shape, generator=generator,
                      device=probs.device) < probs
    return keep, probs
