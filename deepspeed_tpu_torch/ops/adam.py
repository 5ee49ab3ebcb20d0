"""Optimizers (port of deepspeed_tpu/ops/adam.py) — the math of the
reference's FusedAdam/AdamW, FusedLamb, Adagrad and SGD.

The JAX package's functional interface is kept:

    state = opt.init(params)
    params, state = opt.step(params, grads, state, lr)

over nested-dict parameter trees, with the reference's state (``step`` and
the moments, in f32) and the reference's update formulas. They are not
``torch.optim`` classes: the JAX package's semantics, not torch's, are the
contract. ``step`` updates the parameter and state tensors in place (the
port's memory saving over the reference's fresh arrays) and returns them.
``DeepSpeedCPUAdam`` is FusedAdam's math; the engine keeps its state in
host memory when ``zero_optimization.offload_optimizer`` says so
(runtime/zero/offload.py, on the native kernels of ops/cpu_adam_native.py).
The 1-bit optimizers are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: int
    exp_avg: Any  # tree like params
    exp_avg_sq: Any


def _zeros_like(params, dtype=torch.float32):
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params)


def _bias_correction(beta: float, count: int) -> float:
    """``1 - beta ** count`` computed in f32, as the reference does."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(count))


def _apply(params, fn, *trees):
    """Run ``fn(p, *leaves)`` over the leaves, in tree order, under no_grad."""
    with torch.no_grad():
        for leaves in zip(tree_leaves(params), *map(tree_leaves, trees)):
            fn(*leaves)


@dataclasses.dataclass
class FusedAdam:
    """Adam/AdamW (reference FusedAdam); ``adam_w_mode=True`` gives decoupled
    weight decay (AdamW), matching the reference's default."""

    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True
    amsgrad: bool = False

    name = "adam"

    def __post_init__(self):
        if self.amsgrad:
            raise ValueError("FusedAdam does not support amsgrad (matches reference)")

    def init(self, params) -> AdamState:
        return AdamState(step=0, exp_avg=_zeros_like(params),
                         exp_avg_sq=_zeros_like(params))

    def step(self, params, grads, state: AdamState, lr=None):
        lr = self.lr if lr is None else float(lr)
        b1, b2 = self.betas
        count = state.step + 1
        bc1 = _bias_correction(b1, count) if self.bias_correction else 1.0
        bc2 = _bias_correction(b2, count) if self.bias_correction else 1.0
        wd = self.weight_decay

        def upd(p, g, m, v):
            g = g.to(m.dtype)
            if wd > 0.0 and not self.adam_w_mode:
                g = g + wd * p.to(g.dtype)   # L2 mode: decay into the gradient
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * (g * g))
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if wd > 0.0 and self.adam_w_mode:
                update = update + wd * p.to(update.dtype)
            p.copy_(p.float() - lr * update)

        _apply(params, upd, grads, state.exp_avg, state.exp_avg_sq)
        return params, AdamState(step=count, exp_avg=state.exp_avg,
                                 exp_avg_sq=state.exp_avg_sq)


@dataclasses.dataclass
class DeepSpeedCPUAdam(FusedAdam):
    """FusedAdam's math; the engine places its state in host memory when
    ``offload_optimizer.device`` is ``cpu`` or ``nvme`` (reference
    ops/adam/cpu_adam.py)."""

    name = "cpu_adam"
    host_state: bool = True


class LambState(NamedTuple):
    step: int
    exp_avg: Any
    exp_avg_sq: Any


@dataclasses.dataclass
class FusedLamb:
    """LAMB with per-tensor trust ratio (reference FusedLamb)."""

    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_coeff: float = 10.0
    min_coeff: float = 0.01
    bias_correction: bool = True

    name = "lamb"

    def init(self, params) -> LambState:
        return LambState(step=0, exp_avg=_zeros_like(params),
                         exp_avg_sq=_zeros_like(params))

    def step(self, params, grads, state: LambState, lr=None):
        lr = self.lr if lr is None else float(lr)
        b1, b2 = self.betas
        count = state.step + 1
        bc1 = _bias_correction(b1, count) if self.bias_correction else 1.0
        bc2 = _bias_correction(b2, count) if self.bias_correction else 1.0

        def upd(p, g, m, v):
            g = g.to(m.dtype)
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * (g * g))
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay > 0.0:
                update = update + self.weight_decay * p.to(update.dtype)
            w_norm = torch.linalg.vector_norm(p.float())
            u_norm = torch.linalg.vector_norm(update)
            trust = torch.where((w_norm > 0) & (u_norm > 0),
                                torch.clamp(w_norm / u_norm, self.min_coeff,
                                            self.max_coeff),
                                torch.ones_like(w_norm))
            p.copy_(p.float() - lr * trust * update)

        _apply(params, upd, grads, state.exp_avg, state.exp_avg_sq)
        return params, LambState(step=count, exp_avg=state.exp_avg,
                                 exp_avg_sq=state.exp_avg_sq)


class AdagradState(NamedTuple):
    step: int
    sum_sq: Any


@dataclasses.dataclass
class Adagrad:
    """Adagrad (the reference's DeepSpeedCPUAdagrad math, on the device)."""

    lr: float = 1e-2
    eps: float = 1e-10
    weight_decay: float = 0.0

    name = "adagrad"

    def init(self, params) -> AdagradState:
        return AdagradState(step=0, sum_sq=_zeros_like(params))

    def step(self, params, grads, state: AdagradState, lr=None):
        lr = self.lr if lr is None else float(lr)

        def upd(p, g, s):
            g = g.to(s.dtype)
            if self.weight_decay > 0.0:
                g = g + self.weight_decay * p.to(g.dtype)
            s.add_(g * g)
            p.copy_(p.float() - lr * g / (torch.sqrt(s) + self.eps))

        _apply(params, upd, grads, state.sum_sq)
        return params, AdagradState(step=state.step + 1, sum_sq=state.sum_sq)


DeepSpeedCPUAdagrad = Adagrad    # the reference's name for the same math


class SGDState(NamedTuple):
    step: int
    momentum_buf: Any


@dataclasses.dataclass
class SGD:
    lr: float = 1e-2
    momentum: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False

    name = "sgd"

    def init(self, params) -> SGDState:
        return SGDState(step=0, momentum_buf=_zeros_like(params))

    def step(self, params, grads, state: SGDState, lr=None):
        lr = self.lr if lr is None else float(lr)

        def upd(p, g, b):
            g = g.float()
            if self.weight_decay > 0.0:
                g = g + self.weight_decay * p.float()
            if self.momentum == 0.0:
                d = g
            else:
                b.mul_(self.momentum).add_(g)
                d = g + self.momentum * b if self.nesterov else b
            p.copy_(p.float() - lr * d)

        _apply(params, upd, grads, state.momentum_buf)
        return params, SGDState(step=state.step + 1,
                                momentum_buf=state.momentum_buf)


def _not_ported(name):
    def make(**kw):
        raise NotPortedError(f"optimizer {name!r} is not ported to the "
                             "PyTorch engine yet")
    return make


OPTIMIZER_REGISTRY: Dict[str, Any] = {
    "adam": FusedAdam,
    "adamw": lambda **kw: FusedAdam(adam_w_mode=True, **kw),
    "fusedadam": FusedAdam,
    "cpu_adam": DeepSpeedCPUAdam,
    "deepspeedcpuadam": DeepSpeedCPUAdam,
    "lamb": FusedLamb,
    "fusedlamb": FusedLamb,
    "adagrad": Adagrad,
    "sgd": SGD,
    "onebitadam": _not_ported("OnebitAdam"),
    "onebitlamb": _not_ported("OnebitLamb"),
    "zerooneadam": _not_ported("ZeroOneAdam"),
}


def build_optimizer(name: str, params_dict: Optional[Dict[str, Any]] = None):
    """Build an optimizer from a DeepSpeed-style config section, with the
    reference's name normalisation (case and underscores ignored)."""
    key = name.lower().replace("_", "").replace("one" + "bit", "onebit")
    table = {k.replace("_", ""): v for k, v in OPTIMIZER_REGISTRY.items()}
    if key not in table:
        raise ValueError(f"Unknown optimizer '{name}'. Known: {sorted(OPTIMIZER_REGISTRY)}")
    kwargs = dict(params_dict or {})
    if "betas" in kwargs:
        kwargs["betas"] = tuple(kwargs["betas"])
    kwargs.pop("torch_adam", None)
    if key == "adamw":
        kwargs.pop("adam_w_mode", None)
    return table[key](**kwargs)
