"""Training engine (port of deepspeed_tpu/runtime/engine.py: ZeRO stage 0 on
one device).

The reference compiles the whole step into one XLA program; here it is a
Python loop over PyTorch ops on the engine's device, with the reference's
semantics at every point that changes a number:

* fp32 master parameters (``state.params``, plain tensors) and the
  optimizer state of ops/adam.py beside them.
* Per micro-batch: the masters cast to the compute dtype as fresh autograd
  leaves, ``model.apply(..., train=True)``, ``(loss * scale).backward()``,
  and the leaves' grads — the reference's master grads, which are the
  compute-dtype cotangents cast up — cast to ``grad_accum_dtype`` and
  summed in it.
* After ``gas`` micro-batches: ``/ gas``, unscale, the overflow check (fp16,
  or ``resilience.check_finite_grads``), the global norm, clipping, the
  optimizer step, and the scaler update. On overflow the update is skipped
  and ``state.global_step`` (applied updates) does not advance; the host
  counter ``global_steps`` and the LR schedule advance on every step, as
  in the reference.

The overflow flag is read to the host only when it can be set (fp16 or the
finite-grad guard); otherwise a step makes no host sync. Options the port
does not run yet raise :class:`NotPortedError` at construction
(``DeepSpeedConfig.not_ported``), and so do the checkpoint methods.
"""

from __future__ import annotations

from typing import Any, Iterator, NamedTuple, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.ops.adam import build_optimizer
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_scheduler
from deepspeed_tpu_torch.runtime.precision import (LossScalerState,
                                                   StaticLossScaler,
                                                   clip_grads_by_global_norm,
                                                   create_loss_scaler,
                                                   global_grad_norm,
                                                   has_inf_or_nan)
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.tree import tree_map

_ACC_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


class TrainState(NamedTuple):
    params: Any               # fp32 master parameters
    opt_state: Any
    scaler: LossScalerState
    global_step: int          # applied (not skipped) updates


def _stack(micro_batches):
    """Stack micro-batches (dicts or arrays) on a new leading [gas] dim."""
    first = micro_batches[0]
    if isinstance(first, dict):
        return {k: _stack([mb[k] for mb in micro_batches]) for k in first}
    return np.stack([np.asarray(mb) for mb in micro_batches])


class DeepSpeedEngine:
    def __init__(self, model, config: Union[DeepSpeedConfig, dict, str], *,
                 optimizer=None, lr_scheduler=None, training_data=None,
                 collate_fn=None, device=None, params=None):
        if not isinstance(config, DeepSpeedConfig):
            config = DeepSpeedConfig(config)
        missing = config.not_ported()
        if missing:
            raise NotPortedError(
                f"config options not ported to the PyTorch engine yet: "
                f"{', '.join(missing)}")
        self.config = config
        self._config = config  # reference attribute name
        self.module = model
        self.accelerator = get_accelerator(device)
        self.device = self.accelerator.device()

        # ---- precision policy
        self.fp16_enabled = config.fp16_enabled
        self.bfloat16_enabled = config.bfloat16_enabled
        if self.fp16_enabled:
            self.compute_dtype = torch.float16
            self.loss_scaler = create_loss_scaler(config.fp16_config)
        elif self.bfloat16_enabled:
            self.compute_dtype = torch.bfloat16
            self.loss_scaler = StaticLossScaler(1.0)
        else:
            self.compute_dtype = torch.float32
            self.loss_scaler = StaticLossScaler(1.0)
        self.grad_accum_dtype = _ACC_DTYPES[config.grad_accum_dtype]
        self.zero_stage = config.zero_optimization_stage
        rcfg = config.resilience_config
        self._check_finite_grads = bool(rcfg.check_finite_grads)

        # ---- optimizer and LR schedule (reference _configure_optimizer)
        if optimizer is None and config.optimizer_name is not None:
            optimizer = build_optimizer(config.optimizer_name, config.optimizer_params)
        if optimizer is None:
            optimizer = build_optimizer("adam", {"lr": 1e-3})
        self.optimizer = optimizer
        if lr_scheduler is None and config.scheduler_name is not None:
            lr_scheduler = build_lr_scheduler(config.scheduler_name,
                                              config.scheduler_params, optimizer)
        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is not None and self.lr_scheduler.last_batch_iteration < 0:
            self.lr_scheduler.step(0)  # prime initial LR (warmup start)

        # ---- state
        self.state = self._init_state(params)
        self._dropout_rng = torch.Generator(device=self.device).manual_seed(
            (int(config.seed) ^ 0x5eed) & 0x7FFFFFFF)

        # ---- counters (reference engine attrs)
        self.micro_steps = 0
        self.global_steps = 0
        self.skipped_steps = 0
        self.gas = config.gradient_accumulation_steps
        self._grad_acc = None       # accumulated grads for forward/backward/step
        self._acc_count = 0
        self._pending = None
        self._global_grad_norm = None

        self.training_dataloader = None
        self._train_iter = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data,
                                                         collate_fn=collate_fn)
        log_dist(
            f"DeepSpeedEngine: zero_stage={self.zero_stage} "
            f"dtype={self.compute_dtype} device={self.device} batch triple="
            f"({config.train_batch_size},{config.train_micro_batch_size_per_gpu},"
            f"{config.gradient_accumulation_steps})", ranks=[0])

    # ------------------------------------------------------------------- init
    def _init_state(self, params) -> TrainState:
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(self.config.seed))
            params = self.module.init(gen, device=self.device, dtype=torch.float32)
        else:
            params = tree_map(lambda p: p.detach().to(self.device).clone(), params)
        return TrainState(params=params, opt_state=self.optimizer.init(params),
                          scaler=self.loss_scaler.init(), global_step=0)

    # ---------------------------------------------------------- micro helpers
    def _cast_for_compute(self, params):
        """``params`` in the compute dtype, outside autograd (f32 leaves
        cast, others shared)."""
        return tree_map(lambda p: p.detach().to(self.compute_dtype)
                        if p.dtype == torch.float32 else p.detach(), params)

    def _compute_params(self):
        """The masters as compute-dtype autograd leaves."""
        return tree_map(lambda c: c.requires_grad_(),
                        self._cast_for_compute(self.state.params))

    def _to_device(self, batch):
        def move(x):
            t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
            if not (t.is_floating_point() or t.is_complex()):
                t = t.long()
            return t.to(self.device)

        return tree_map(move, batch) if isinstance(batch, dict) else move(batch)

    def _micro_loss(self, batch):
        """``(loss, scaled_loss, leaves)`` of one micro-batch, graph kept."""
        leaves = self._compute_params()
        loss, _ = self.module.apply(leaves, batch,
                                    rngs={"dropout": self._dropout_rng},
                                    train=True)
        return loss, loss * self.state.scaler.cur_scale, leaves

    def _accumulate(self, leaves):
        """Add the leaves' grads, cast to grad_accum_dtype, into the sum."""
        def grad(p):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            return g.to(self.grad_accum_dtype)

        grads = tree_map(grad, leaves)
        if self._grad_acc is None:
            self._grad_acc = grads
        else:
            tree_map(lambda a, g: a.add_(g), self._grad_acc, grads)

    def _apply_grads(self, grads, lr: float):
        """unscale -> overflow check -> norm -> clip -> optimizer -> scale
        update (the reference's _apply_grads). ``grads`` are already divided
        by gas."""
        state = self.state
        inv = float(np.float32(1.0) / np.float32(state.scaler.cur_scale))
        grads = tree_map(lambda g: g.float() * inv, grads)
        overflow = False
        if self.fp16_enabled or self._check_finite_grads:
            overflow = bool(has_inf_or_nan(grads))
        norm = global_grad_norm(grads)
        if self.config.gradient_clipping > 0:
            grads, norm = clip_grads_by_global_norm(
                grads, self.config.gradient_clipping, norm)
        params, opt_state = state.params, state.opt_state
        if not overflow:
            params, opt_state = self.optimizer.step(params, grads, opt_state, lr)
        else:
            self.skipped_steps += 1
        self.state = TrainState(
            params=params, opt_state=opt_state,
            scaler=self.loss_scaler.update(state.scaler, overflow),
            global_step=state.global_step + (0 if overflow else 1))
        self._global_grad_norm = norm

    def _finish_step(self):
        self.global_steps += 1
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()

    # --------------------------------------------------------------- user API
    def _ensure_train_iter(self):
        assert self.training_dataloader is not None, \
            "train_batch needs a data_iter or training_data at init"
        if self._train_iter is None:
            from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

            self._train_iter = iter(RepeatingLoader(self.training_dataloader))
        return self._train_iter

    def train_batch(self, data_iter: Optional[Iterator] = None):
        """Pull ``gas`` micro-batches and run one step; returns the mean
        micro-batch loss (a 0-d f32 tensor on the device)."""
        if data_iter is None:
            data_iter = self._ensure_train_iter()
        return self._run_step(_stack([next(data_iter) for _ in range(self.gas)]))

    def train_batch_from_stacked(self, batch):
        """As train_batch, but the caller supplies the [gas, ...] stacked batch."""
        return self._run_step(batch)

    def _run_step(self, batch):
        lr = self.get_lr()[0]
        batch = self._to_device(batch)
        loss_sum = None
        for i in range(self.gas):
            mb = tree_map(lambda x: x[i], batch) if isinstance(batch, dict) else batch[i]
            loss, scaled, leaves = self._micro_loss(mb)
            scaled.backward()
            self._accumulate(leaves)
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads, self._grad_acc = self._grad_acc, None
        grads = tree_map(lambda g: g.float() / self.gas, grads)
        self._apply_grads(grads, lr)
        self.micro_steps += self.gas
        self._finish_step()
        loss = loss_sum / self.gas
        self._log_step(loss)
        return loss

    def _log_step(self, loss):
        n = self.config.steps_per_print
        if n and self.global_steps % n == 0:
            log_dist(f"step={self.global_steps} loss={float(loss):.4f} "
                     f"lr={self.get_lr()[0]:.3e}", ranks=[0])

    # ------------------------------------------ forward/backward/step parity
    def forward(self, batch):
        """Loss of one micro-batch; its graph is kept for backward()."""
        loss, scaled, leaves = self._micro_loss(self._to_device(batch))
        self._pending = (scaled, leaves)
        return loss.detach()

    __call__ = forward

    def backward(self, loss=None, allreduce_gradients: bool = True):
        """Accumulate the pending micro-batch's grads (reference backward)."""
        assert self._pending is not None, "backward() must follow forward()"
        scaled, leaves = self._pending
        self._pending = None
        scaled.backward()
        self._accumulate(leaves)
        self._acc_count += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return (self.micro_steps + 1) % self.gas == 0

    def step(self):
        """Apply the optimizer at the gas boundary (reference step)."""
        if self.is_gradient_accumulation_boundary():
            assert self._acc_count == self.gas, (
                f"step() at boundary needs {self.gas} backward() calls, "
                f"got {self._acc_count}")
            grads, self._grad_acc = self._grad_acc, None
            # / gas in the accumulation dtype, as the reference's step()
            grads = tree_map(lambda g: g / self.gas, grads)
            self._apply_grads(grads, self.get_lr()[0])
            self._acc_count = 0
            self._finish_step()
        self.micro_steps += 1

    # -------------------------------------------------------------- eval path
    def eval_batch(self, batch):
        with torch.no_grad():
            cparams = self._cast_for_compute(self.state.params)
            loss, _ = self.module.apply(cparams, self._to_device(batch),
                                        rngs=None, train=False)
        return loss

    # ------------------------------------------------------------- accessors
    def get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_last_lr()
        return [getattr(self.optimizer, "lr", 1e-3)]

    def get_global_grad_norm(self):
        return None if self._global_grad_norm is None else float(self._global_grad_norm)

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def gradient_accumulation_steps(self) -> int:
        return self.gas

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    @property
    def params(self):
        return self.state.params

    def get_loss_scale(self) -> float:
        return float(self.state.scaler.cur_scale)

    # --------------------------------------------------------------- data io
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None, **kw):
        from deepspeed_tpu_torch.runtime.dataloader import build_dataloader

        if batch_size is None:
            batch_size = (self.config.train_micro_batch_size_per_gpu
                          * self.config.data_parallel_size)
        return build_dataloader(dataset, batch_size, config=self.config,
                                collate_fn=collate_fn, **kw)

    # ----------------------------------------------------------- checkpoints
    def save_checkpoint(self, *args, **kwargs):
        raise NotPortedError("checkpointing is not ported to the PyTorch "
                             "engine yet")

    load_checkpoint = save_checkpoint
    save_16bit_model = save_checkpoint
