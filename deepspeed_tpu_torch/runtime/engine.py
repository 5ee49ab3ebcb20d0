"""Training engine (port of deepspeed_tpu/runtime/engine.py on one device:
ZeRO stages 0-3, whose one-device plan keeps every leaf whole, and
ZeRO-Offload / ZeRO-Infinity).

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

With ``zero_optimization.offload_optimizer`` (``cpu`` or ``nvme``) the f32
masters and moments live on the host (runtime/zero/offload.py) and the
card keeps the compute-dtype images as ``state.params``. A step computes
the gas micro-batches' grads on the card, divides by gas and unscales in
one f32 multiply by ``1 / (gas * scale)``, checks for overflow and takes
the global norm there (the reference's host-path epilogue, one multiply
where the device path takes two), reads the flag and the norm to the
host, and runs the host step with the clip factor as ``grad_scale``,
which downloads the grads and uploads the images. On overflow the update
is skipped and the scaler advances.

The overflow flag is read to the host only when it can be set (fp16 or the
finite-grad guard): the skip decides the optimizer's host-side step count.
Otherwise a device-state step makes no host sync.
Options the port does not run yet raise :class:`NotPortedError` at construction
(``DeepSpeedConfig.not_ported``). Checkpoints (``save_checkpoint``,
``load_checkpoint``, ``save_16bit_model``) use the reference's format
(runtime/checkpoint_engine/), with a ``checkpoint_save`` /
``checkpoint_load`` span on the tracer.

Telemetry (the ``telemetry`` section, on by default as in the reference):
every step adds ``train/steps``, ``train/tokens`` and a
``train/step_wall_ms`` observation (host wall: on the card the launches,
not the device work); every ``sync_interval`` steps, and at step 1, one
``torch.cuda.synchronize`` (the only host sync telemetry adds) reads the
device rate since the last fence (``train/device_step_time_ms``,
``train/tokens_per_sec``, ``train/model_tflops``, ``train/mfu``) and the
step's scalars (``train/grad_norm``, ``train/loss``, fp16's
``train/loss_scale`` and ``train/fp16_skipped_steps``, the finite-grad
guard's ``train/nonfinite_skipped_steps``, ``device/mem_*``). With
``telemetry.spans`` each fence-to-fence window is a ``step_window`` span;
``telemetry.flight_recorder`` tees the stream into a flight recorder.
``wall_clock_breakdown`` times the forward, backward, optimizer step and
whole batch on CUDA events (utils/timer.py), read and logged every
``steps_per_print`` steps. The step's FLOPs follow each step's sequence
length and random-LTD's kept tokens (``_train_step_flops``): the
reference counts its first step only.

Resilience (the ``resilience`` section, as the reference wires it):
``enabled`` arms the anomaly sentinel (runtime/sentinel.py) and the
finite-grad guard (which follows ``enabled`` unless
``check_finite_grads`` says otherwise). Each ``train_batch`` step queues
its loss, grad norm and overflow flag as one small device tensor; every
``check_interval`` steps (0: the telemetry fence's ``sync_interval``)
one device-to-host copy reads them all and the sentinel classifies each
step. An anomaly with ``checkpoint_dir`` set and an engine-owned data
stream rewinds: the newest valid tag is loaded (walking back past a
corrupt one), with the dataloader position from its ``__meta__``, and the
offending batches are skipped (``rewind_log``; the rolling
``max_rewinds`` budget). ``sdc_audit_interval`` runs the cross-replica
checksum vote (one voter on one device), ``step_replay_interval`` the
step-replay probe: ``_train_step`` — the step's device arithmetic, which
``_run_step`` runs too — twice on clones of the state.
``install_preemption_handler`` saves a final tag on SIGTERM or
``trigger()`` and exits with the restartable code 101: at once between
steps; deferred (or inside a step, whatever ``defer`` says) at the next
step boundary, which is the end of the step in flight or the start of the
next, before it pulls its batches.

Data efficiency, as the reference wires it (``train_batch``): the legacy
curriculum truncates each batch to the scheduled length on the host;
random-LTD passes the scheduler's kept-token count to ``model.apply`` as
``ltd_keep`` (both step paths); progressive layer drop passes
``pld_theta`` on the device-state path (the reference's host-optimizer
step takes none) and advances its schedule after every step, on the
forward/backward/step path too. The monitors (``tensorboard``, ``wandb``,
``csv_monitor``, ``jsonl_monitor``) get the loss, the LR and fp16's loss
scale every ``monitor_interval`` steps (default ``steps_per_print``). The
generator that draws attention dropout draws PLD's and LTD's masks.
"""

from __future__ import annotations

import contextlib
import inspect
import time
from typing import Any, Iterator, NamedTuple, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.monitor.monitor import MonitorMaster
from deepspeed_tpu_torch.ops.adam import build_optimizer
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_scheduler
from deepspeed_tpu_torch.runtime.precision import (LossScalerState,
                                                   StaticLossScaler,
                                                   clip_grads_by_global_norm,
                                                   create_loss_scaler,
                                                   global_grad_norm,
                                                   has_inf_or_nan)
from deepspeed_tpu_torch.runtime.zero.config import OffloadDeviceEnum
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer, param_names
from deepspeed_tpu_torch.telemetry import (FlightRecorder, JsonlSink,
                                           SpanTracer, accelerator_peaks,
                                           get_registry, mfu, record_event,
                                           roofline_row)
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER,
                                             FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER,
                                             TRAIN_BATCH_TIMER,
                                             SynchronizedWallClockTimer)
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

_ACC_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


class TrainState(NamedTuple):
    params: Any               # fp32 masters (offload: compute-dtype images)
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
        # the finite-grad guard follows ``resilience.enabled`` when unset
        self._check_finite_grads = (bool(rcfg.check_finite_grads)
                                    if rcfg.check_finite_grads is not None
                                    else bool(rcfg.enabled))

        # ---- optimizer and LR schedule (reference _configure_optimizer)
        if optimizer is None and config.optimizer_name is not None:
            optimizer = build_optimizer(config.optimizer_name, config.optimizer_params)
        if optimizer is None:
            optimizer = build_optimizer("adam", {"lr": 1e-3})
        self.optimizer = optimizer
        # ---- host (ZeRO-Offload / Infinity) optimizer: f32 masters and
        # moments in host memory or on NVMe, the step on the host's cores
        offload = config.zero_config.offload_optimizer
        self.offload_optimizer = bool(
            offload is not None and offload.device != OffloadDeviceEnum.none)
        self._host_opt = None
        if self.offload_optimizer:
            try:
                self._host_opt = HostOffloadOptimizer(optimizer, offload,
                                                      self.compute_dtype)
            except ValueError as e:
                log_dist(f"offload_optimizer: {e}; keeping device-state path",
                         ranks=[0])
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
        # the forward/backward/step path's tokens and start since the last
        # boundary (its step telemetry)
        self._path_tokens = 0
        self._path_seq = 0
        self._path_t0: Optional[float] = None
        self._path_loss = None

        self._init_data_efficiency(config)
        self.monitor = MonitorMaster(config.monitor_config)

        # ---- wall-clock breakdown: CUDA-event timers, read at the log
        self.timers = (SynchronizedWallClockTimer(self.device)
                       if config.wall_clock_breakdown else None)
        self._init_telemetry(config.telemetry_config)

        self.training_dataloader = None
        self._train_iter = None
        self._engine_owned_stream = False
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data,
                                                         collate_fn=collate_fn)
        self._init_resilience(rcfg, config.telemetry_config)
        self._preemption_handler = None
        self._in_step = False
        log_dist(
            f"DeepSpeedEngine: zero_stage={self.zero_stage} "
            f"dtype={self.compute_dtype} device={self.device} batch triple="
            f"({config.train_batch_size},{config.train_micro_batch_size_per_gpu},"
            f"{config.gradient_accumulation_steps})", ranks=[0])

    # ------------------------------------------------------------------- init
    def _init_data_efficiency(self, config) -> None:
        """Progressive layer drop, random-LTD and the legacy curriculum
        (the reference's construction, engine.py:193-240 and its
        curriculum block)."""
        accepts = inspect.signature(self.module.apply).parameters
        self.progressive_layer_drop = None
        self._use_pld = False
        if config.pld_config.enabled:
            from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop

            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=config.pld_config.theta, gamma=config.pld_config.gamma)
            self._use_pld = "pld_theta" in accepts
            if not self._use_pld:
                log_dist("progressive_layer_drop: model.apply does not "
                         "accept pld_theta — schedule tracked but layers "
                         "are NOT dropped", ranks=[0])
        self.random_ltd_scheduler = None
        self._use_random_ltd = False
        if config.random_ltd_enabled:
            from deepspeed_tpu_torch.runtime.data_pipeline.random_ltd import RandomLTDScheduler

            self.random_ltd_scheduler = RandomLTDScheduler(config.random_ltd_params)
            self._use_random_ltd = "ltd_keep" in accepts
            if not self._use_random_ltd:
                log_dist("random_ltd: model.apply does not accept "
                         "ltd_keep — schedule tracked but tokens are NOT "
                         "dropped", ranks=[0])
            elif self._use_pld:
                log_dist("random_ltd and progressive_layer_drop are "
                         "mutually exclusive; disabling random_ltd",
                         ranks=[0])
                self._use_random_ltd = False
        self.curriculum_scheduler = None
        if config.curriculum_enabled_legacy:
            from deepspeed_tpu_torch.runtime.data_pipeline import CurriculumScheduler

            self.curriculum_scheduler = CurriculumScheduler(
                config.curriculum_params_legacy)

    def _init_telemetry(self, tcfg) -> None:
        """The registry, the owned JSONL sink, the span tracer and the
        flight recorder's tee, as the reference arms them."""
        self.telemetry = None
        self._telemetry_flops: Optional[float] = None   # None: not counted
        self._telemetry_bytes: Optional[float] = None
        self._param_counts = None        # (elements, state bytes), counted once
        self._fence_t: Optional[float] = None
        self._fence_step = 0
        self._fence_tokens = 0
        self._fence_flops = 0.0
        self._owned_sink = None
        self.tracer = None
        self._train_trace = None
        self._spans_sink = None
        self.flight_recorder = None
        self.slo = None
        if tcfg.enabled:
            self.telemetry = get_registry()
            if tcfg.jsonl_path and self.telemetry.sink is None:
                self._owned_sink = JsonlSink(tcfg.jsonl_path)
                self.telemetry.attach_sink(self._owned_sink)
            if tcfg.spans:
                span_sink = None
                if tcfg.spans_path:
                    self._spans_sink = JsonlSink(tcfg.spans_path)
                    span_sink = self._spans_sink
                if span_sink is None:
                    span_sink = self.telemetry.sink   # interleaved, if any
                self.tracer = SpanTracer(sink=span_sink)
                self._train_trace = self.tracer.new_trace()
        # the sink this engine attached to the global registry (the owned
        # sink, or the flight recorder's tee around it): destroy() detaches
        # exactly that
        self._attached_sink = self._owned_sink
        if tcfg.enabled and tcfg.flight_recorder:
            self.flight_recorder = FlightRecorder(
                dump_dir=tcfg.flight_dir or None, registry=self.telemetry)
            self._attached_sink = self.flight_recorder.tee(
                self.telemetry.sink)
            self.telemetry.attach_sink(self._attached_sink)
            if self.tracer is not None:
                if self._spans_sink is not None \
                        and self.tracer.sink is self._spans_sink:
                    self.tracer.sink = self.flight_recorder.tee(
                        self._spans_sink)
                else:
                    # interleaved spans ride the registry's sink, now the
                    # tee: each span is recorded once
                    self.tracer.sink = self.telemetry.sink

    def _init_resilience(self, rcfg, tcfg) -> None:
        """The anomaly sentinel, the rewind budget and the recovery log
        (the reference's construction). The sentinel's per-step scalars
        queue as device tensors and are read in one copy at the check
        fence, every ``check_interval`` steps (0: the telemetry fence's
        ``sync_interval``, else every step)."""
        self.resilience_config = rcfg
        self.sentinel = None
        self._pending_anomaly_reads: list = []
        self._rewind_budget = None
        self._rewinds_since_clean = 0
        self._last_anomaly_step = -1
        self._resilience_baseline_saved = False
        self._sdc_quarantine_cb = None
        self.sdc_suspect_devices = ()
        self.rewind_log: list = []
        self._no_overflow = None
        if rcfg.enabled:
            from deepspeed_tpu_torch.elasticity.elastic_agent import RollingWindowBudget
            from deepspeed_tpu_torch.runtime.sentinel import TrainingSentinel

            self.sentinel = TrainingSentinel(
                window=rcfg.window, min_history=rcfg.min_history,
                spike_zscore=rcfg.spike_zscore,
                divergence_patience=rcfg.divergence_patience,
                fp16=self.fp16_enabled)
            self._rewind_budget = RollingWindowBudget(
                rcfg.max_rewinds, rcfg.rewind_window_s)
            # the flag queued for a step whose flag is never set
            self._no_overflow = torch.zeros((), device=self.device)
        self._sentinel_interval = rcfg.check_interval or (
            tcfg.sync_interval if (self.telemetry is not None
                                   and tcfg.sync_interval) else 1)

    def _init_state(self, params) -> TrainState:
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(self.config.seed))
            params = self.module.init(gen, device=self.device, dtype=torch.float32)
        else:
            params = tree_map(lambda p: p.detach().to(self.device).clone(), params)
        if self._host_opt is not None:
            # the masters go to the host; the card keeps only the
            # compute-dtype image (the f32 init is freed with ``params``)
            self._host_opt.init(params)
            params = self._cast_for_compute(params)
            return TrainState(params=params, opt_state={},
                              scaler=self.loss_scaler.init(), global_step=0)
        return TrainState(params=params, opt_state=self.optimizer.init(params),
                          scaler=self.loss_scaler.init(), global_step=0)

    # ---------------------------------------------------------- micro helpers
    def _cast_for_compute(self, params):
        """``params`` in the compute dtype, outside autograd (f32 leaves
        cast, others shared)."""
        return tree_map(lambda p: p.detach().to(self.compute_dtype)
                        if p.dtype == torch.float32 else p.detach(), params)

    def _compute_params(self, params):
        """``params`` (the masters) as compute-dtype autograd leaves."""
        return tree_map(lambda c: c.requires_grad_(),
                        self._cast_for_compute(params))

    def _to_device(self, batch):
        def move(x):
            t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
            if not (t.is_floating_point() or t.is_complex()):
                t = t.long()
            return t.to(self.device)

        return tree_map(move, batch) if isinstance(batch, dict) else move(batch)

    def _micro_loss(self, state, batch, **kwargs):
        """``(loss, scaled_loss, leaves)`` of one micro-batch on ``state``,
        graph kept; ``kwargs`` (``pld_theta``, ``ltd_keep``) go to
        ``model.apply``."""
        leaves = self._compute_params(state.params)
        loss, _ = self.module.apply(leaves, batch,
                                    rngs={"dropout": self._dropout_rng},
                                    train=True, **kwargs)
        return loss, loss * state.scaler.cur_scale, leaves

    def _accumulate(self, leaves, acc=None):
        """``acc`` plus the leaves' grads, cast to grad_accum_dtype (the
        grads themselves when ``acc`` is None)."""
        def grad(p):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            return g.to(self.grad_accum_dtype)

        grads = tree_map(grad, leaves)
        if acc is None:
            acc = grads
        else:
            tree_map(lambda a, g: a.add_(g), acc, grads)
        for p in tree_leaves(leaves):
            p.grad = None               # summed: free it before the step
        return acc

    def _micro_grads(self, state, batch, kwargs, timed: bool):
        """The gas micro-batches' forwards and backwards on ``state``:
        ``(mean loss, summed grads)``; ``timed`` runs the wall-clock
        breakdown's forward and backward timers."""
        loss_sum = acc = None
        for i in range(self.gas):
            mb = tree_map(lambda x: x[i], batch) if isinstance(batch, dict) else batch[i]
            if timed:
                self._timer(FORWARD_GLOBAL_TIMER, True)
            loss, scaled, leaves = self._micro_loss(state, mb, **kwargs)
            if timed:
                self._timer(FORWARD_GLOBAL_TIMER, False)
                self._timer(BACKWARD_GLOBAL_TIMER, True)
            scaled.backward()
            acc = self._accumulate(leaves, acc)
            if timed:
                self._timer(BACKWARD_GLOBAL_TIMER, False)
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return loss_sum / self.gas, acc

    def _train_step(self, state, batch, lr: float, kwargs=None,
                    timed: bool = False):
        """The device arithmetic of one device-state ``train_batch`` step
        on ``state``: the micro-batches' losses and backwards, the
        accumulation, then :meth:`_apply_grads` (the guard and the
        optimizer). Returns ``(new_state, metrics)``; the optimizer updates
        ``state``'s tensors in place. Nothing else of the engine moves —
        not ``global_steps``, the LR schedule, telemetry, the monitors or
        PLD / LTD — so the step-replay probe runs exactly this on a copy;
        ``_run_step`` runs it on the live state."""
        loss, acc = self._micro_grads(state, batch, kwargs or {}, timed)
        if timed:
            self._timer(STEP_GLOBAL_TIMER, True)
        grads = tree_map(lambda g: g.float() / self.gas, acc)
        del acc
        state, metrics = self._apply_grads(state, grads, lr)
        if timed:
            self._timer(STEP_GLOBAL_TIMER, False)
        metrics["loss"] = loss
        return state, metrics

    def _apply_grads(self, state, grads, lr: float):
        """unscale -> overflow check -> norm -> clip -> optimizer -> scale
        update (the reference's _apply_grads) on ``state``. ``grads`` are
        already divided by gas. Returns ``(new_state, metrics)``: the
        global norm and the overflow flag (a 0-d device tensor, None when
        nothing checks it) and ``skipped``, the flag on the host: the skip
        decides the optimizer's host-side step count, so the flag is read
        here whenever it can be set (fp16 or the finite-grad guard)."""
        inv = float(np.float32(1.0) / np.float32(state.scaler.cur_scale))
        grads = tree_map(lambda g: g.float() * inv, grads)
        flag, overflow = None, False
        if self.fp16_enabled or self._check_finite_grads:
            flag = has_inf_or_nan(grads)
            overflow = bool(flag)
        norm = global_grad_norm(grads)
        if self.config.gradient_clipping > 0:
            grads, norm = clip_grads_by_global_norm(
                grads, self.config.gradient_clipping, norm)
        params, opt_state = state.params, state.opt_state
        if not overflow:
            params, opt_state = self.optimizer.step(params, grads, opt_state, lr)
        new_state = TrainState(
            params=params, opt_state=opt_state,
            scaler=self.loss_scaler.update(state.scaler, overflow),
            global_step=state.global_step + (0 if overflow else 1))
        return new_state, {"grad_norm": norm, "overflow": flag,
                           "skipped": overflow}

    def _unscale_epilogue(self):
        """The host path's epilogue (the reference's ``_unscale_epilogue``):
        the accumulated grads, taken over, to f32 times ``1 / (gas *
        scale)``, the overflow flag and the global norm, on the device.
        Returns the f32 grads by name, the flag (a 0-d tensor, or None
        when nothing checks it), the flag read to the host, and the norm.
        Each leaf is converted in place (f32) or replaced, so the
        accumulator frees as the f32 grads appear."""
        inv = float(np.float32(1.0) / (np.float32(self.gas)
                                       * np.float32(self.state.scaler.cur_scale)))
        flat = param_names(self._take_grads())
        for name, g in flat.items():
            flat[name] = g.float().mul_(inv)
        flag, overflow = None, False
        if self.fp16_enabled or self._check_finite_grads:
            flag = has_inf_or_nan(flat)
            overflow = bool(flag)
        return flat, flag, overflow, global_grad_norm(flat)

    def _host_apply(self, lr: float):
        """The host-optimizer step (the reference's ``_host_apply``): the
        epilogue on the card, the clip factor from the norm, then the host
        update and the images' upload; on overflow only the scaler moves.
        Returns the step's metrics (as :meth:`_apply_grads`')."""
        flat, flag, overflow, norm = self._unscale_epilogue()
        state = self.state
        self._global_grad_norm = norm
        metrics = {"grad_norm": norm, "overflow": flag, "skipped": overflow}
        new_scaler = self.loss_scaler.update(state.scaler, overflow)
        if overflow:
            self.skipped_steps += 1
            self.state = state._replace(scaler=new_scaler)
            return metrics
        clip = self.config.gradient_clipping
        # a host read: the clip factor gates the host step
        factor = min(1.0, clip / (float(norm) + 1e-6)) if clip and clip > 0 \
            else 1.0
        self._host_opt.step(flat, lr, grad_scale=factor,
                            out=param_names(state.params))
        self.state = TrainState(params=state.params, opt_state={},
                                scaler=new_scaler,
                                global_step=state.global_step + 1)
        return metrics

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
        # preemption: a pending notice saves at the step boundary, before
        # this step pulls its batches (the reference polls after the pull,
        # so its tag's loader position is one step ahead of its parameters)
        self._poll_preemption()
        with self._step_in_flight():
            # anomaly rewind can only fast-forward a stream the ENGINE
            # owns; track which source fed the step so recovery never
            # rewinds the engine loader while a caller-supplied iterator
            # keeps advancing
            self._engine_owned_stream = data_iter is None
            if data_iter is None:
                # baseline checkpoint BEFORE the first pull: the rewind
                # target of an anomaly in the first interval must pair
                # step-0 params with dataloader offset 0, or the resumed
                # stream desyncs
                if (self.sentinel is not None
                        and self.resilience_config.checkpoint_dir
                        and not self._resilience_baseline_saved):
                    self._resilience_baseline_saved = True
                    self.save_checkpoint(self.resilience_config.checkpoint_dir)
                data_iter = self._ensure_train_iter()
            loss = self._run_step(_stack([next(data_iter)
                                          for _ in range(self.gas)]))
        self._poll_preemption()
        return loss

    def train_batch_from_stacked(self, batch):
        """As train_batch, but the caller supplies the [gas, ...] stacked batch."""
        self._poll_preemption()
        with self._step_in_flight():
            self._engine_owned_stream = False  # caller owns the data stream
            loss = self._run_step(batch)
        self._poll_preemption()
        return loss

    @contextlib.contextmanager
    def _step_in_flight(self):
        """Marks the span in which the state is mid-update (the batches
        pulled, parameters and moments updated leaf by leaf in place, a
        rewind's reload): a preemption notice that lands there is deferred
        to the poll after it, whatever the handler's ``defer``."""
        self._in_step = True
        try:
            yield
        finally:
            self._in_step = False

    def _poll_preemption(self) -> None:
        if self._preemption_handler is not None:
            self._preemption_handler.poll()

    def _timer(self, name: str, start: bool) -> None:
        """Start or stop a wall-clock-breakdown timer (no-op when off)."""
        if self.timers is None:
            return
        if start:
            self.timers(name).start()
        else:
            self.timers(name).stop(record=True)

    def _run_step(self, batch):
        t_start = time.perf_counter()
        self._timer(TRAIN_BATCH_TIMER, True)
        lr = self.get_lr()[0]
        batch = self._apply_curriculum(batch)
        tokens, seq = self._batch_token_count(batch)
        kwargs = {}
        ltd_keep = None
        if self._use_random_ltd:
            keep = self.random_ltd_scheduler.update_seq(self.global_steps)
            if not seq or keep < seq:
                ltd_keep = kwargs["ltd_keep"] = keep
        if self._use_pld and self._host_opt is None:
            # the reference's host-optimizer step passes no theta
            kwargs["pld_theta"] = self.progressive_layer_drop.get_theta()
        scale = self.state.scaler.cur_scale
        batch = self._to_device(batch)
        if self._host_opt is not None:
            loss, self._grad_acc = self._micro_grads(self.state, batch,
                                                     kwargs, timed=True)
            self._timer(STEP_GLOBAL_TIMER, True)
            metrics = self._host_apply(lr)
            self._timer(STEP_GLOBAL_TIMER, False)
        else:
            self.state, metrics = self._train_step(self.state, batch, lr,
                                                   kwargs, timed=True)
            self.skipped_steps += int(metrics["skipped"])
            self._global_grad_norm = metrics["grad_norm"]
            loss = metrics["loss"]
        self.micro_steps += self.gas
        self._finish_step()
        self._after_step(loss, scale)
        self._timer(TRAIN_BATCH_TIMER, False)
        if self.telemetry is not None:
            self._record_step_telemetry(loss, tokens, seq,
                                        time.perf_counter() - t_start,
                                        ltd_keep=ltd_keep)
        self._log_step(loss)
        if self.sentinel is not None:
            self._resilience_step(loss, metrics, batch)
        return loss

    def _apply_curriculum(self, batch):
        """Legacy curriculum: the sequence keys of the (host) batch cut to
        the scheduled difficulty (the reference's ``_apply_curriculum``,
        its engine.py:1653 ``curriculum_seqlen``)."""
        if self.curriculum_scheduler is None:
            return batch
        seqlen = self.curriculum_scheduler.update_difficulty(
            self.global_steps + 1)
        seq_keys = {"input_ids", "labels", "attention_mask",
                    "token_type_ids", "position_ids"}

        def trunc(node):
            if isinstance(node, dict):
                return {k: (v[..., :seqlen]
                            if k in seq_keys and hasattr(v, "ndim") and
                            v.ndim >= 2 else trunc(v))
                        for k, v in node.items()}
            return node

        return trunc(batch)

    def _after_step(self, loss, loss_scale) -> None:
        """After a train_batch step: the PLD schedule, then the monitors'
        events every ``monitor_interval`` steps (the loss read to the host
        only then): the loss, the next step's LR and, under fp16, the loss
        scale the step ran at."""
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        cfg = self.config
        interval = cfg.monitor_interval or max(cfg.steps_per_print or 0, 1)
        if self.monitor.enabled and self.global_steps % interval == 0:
            step = self.global_steps
            events = [("Train/Samples/train_loss", float(loss), step),
                      ("Train/Samples/lr", self.get_lr()[0], step)]
            if self.fp16_enabled:
                events.append(("Train/Samples/loss_scale", float(loss_scale),
                               step))
            self.monitor.write_events(events)

    def _take_grads(self):
        """The accumulated grads, handed over (the engine keeps no
        reference, so the step may free them as it goes)."""
        grads, self._grad_acc = self._grad_acc, None
        return grads

    def _log_step(self, loss):
        n = self.config.steps_per_print
        if n and self.global_steps % n == 0:
            log_dist(f"step={self.global_steps} loss={float(loss):.4f} "
                     f"lr={self.get_lr()[0]:.3e}", ranks=[0])
            if self.timers is not None:
                self.timers.log([TRAIN_BATCH_TIMER, FORWARD_GLOBAL_TIMER,
                                 BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER],
                                memory_breakdown=self.config.memory_breakdown)

    # -------------------------------------------------------------- telemetry
    @staticmethod
    def _batch_token_count(batch):
        """(tokens, tokens per sequence) of one step's LM batch; (0, 0)
        for any other batch."""
        if isinstance(batch, dict) and "input_ids" in batch:
            shape = tuple(np.shape(batch["input_ids"]))
            if shape:
                return int(np.prod(shape)), int(shape[-1])
        return 0, 0

    def _record_step_telemetry(self, loss, tokens: int, seq: int,
                               wall_dt: float, ltd_keep=None) -> None:
        """Per step: two counters, a histogram observation and the step's
        FLOPs (host arithmetic); everything that needs the device waits for
        the periodic fence."""
        reg = self.telemetry
        reg.counter("train/steps").inc()
        self._fence_flops += self._train_step_flops(tokens, seq, ltd_keep) or 0.0
        if tokens:
            self._fence_tokens += tokens
            reg.counter("train/tokens").inc(tokens)
        reg.histogram("train/step_wall_ms").observe(wall_dt * 1e3)
        interval = self.config.telemetry_config.sync_interval
        if interval and (self.global_steps % interval == 0
                         or self.global_steps == 1):
            self._telemetry_fence(loss)

    def _reset_telemetry_window(self) -> None:
        """Drop the fence-to-fence baseline, so that work between fences
        that is not training steps is not charged to the device rate."""
        self._fence_t = None
        self._fence_step = self.global_steps
        self._fence_tokens = 0
        self._fence_flops = 0.0

    def _telemetry_fence(self, loss) -> None:
        """The periodic fence: one synchronize of the engine's device, then
        the device rate since the previous fence and the step's scalars
        (their reads wait on nothing once the device is drained)."""
        reg = self.telemetry
        self.accelerator.synchronize()
        now = time.perf_counter()
        steps = self.global_steps - self._fence_step
        if self._fence_t is not None and steps > 0:
            if self.tracer is not None:
                # both instants are fences the engine already paid
                self.tracer.record(
                    "step_window", self._fence_t, now,
                    trace_id=self._train_trace, steps=steps,
                    tokens=self._fence_tokens, end_step=self.global_steps)
            dev_step_s = (now - self._fence_t) / steps
            reg.gauge("train/device_step_time_ms").set(dev_step_s * 1e3)
            if self._fence_tokens:
                reg.gauge("train/tokens_per_sec").set(
                    self._fence_tokens / (now - self._fence_t))
            flops = self._fence_flops / steps      # the window's mean step
            if flops:
                reg.gauge("train/model_tflops").set(flops / dev_step_s / 1e12)
                u = mfu(flops, dev_step_s, 1, self.accelerator.device_name())
                if u is not None:
                    reg.gauge("train/mfu").set(u)
        self._fence_step = self.global_steps
        self._fence_tokens = 0
        self._fence_flops = 0.0
        reg.gauge("train/grad_norm").set(float(self._global_grad_norm))
        reg.gauge("train/loss").set(float(loss))
        skipped = max(self.global_steps - self.state.global_step, 0)
        if self.fp16_enabled:
            reg.gauge("train/loss_scale").set(
                float(self.state.scaler.cur_scale))
            reg.gauge("train/fp16_skipped_steps").set(skipped)
        elif self._check_finite_grads:
            reg.gauge("train/nonfinite_skipped_steps").set(skipped)
        stats = self.accelerator.memory_stats()
        if stats:
            reg.gauge("device/mem_in_use_bytes").set(stats["bytes_in_use"])
            reg.gauge("device/mem_peak_bytes").set(stats["peak_bytes_in_use"])
        reg.flush(step=self.global_steps)
        # the next window starts after the reads, so only steps are charged
        self._fence_t = time.perf_counter()

    def _train_step_flops(self, tokens: int, seq: int,
                          ltd_keep: Optional[int] = None) -> Optional[float]:
        """FLOPs of one train step at its own tokens, sequence length (after
        the curriculum's cut) and random-LTD kept tokens; sets
        ``_telemetry_flops`` / ``_telemetry_bytes`` (the train step's
        roofline row). ``cost_analysis`` true:
        ``model.flops_per_token(seq[, ltd_keep]) * tokens`` (forward,
        backward and the attention term; chip_smoke's train_774m counts the
        same), with the
        step's bytes the update's traffic: every f32 master parameter and
        optimizer-state tensor read and written once, and the compute-dtype
        weights read once by the forward and once by the backward (a lower
        bound: activations are left out). Under offload no master or
        optimizer state is on the card: the bytes are the compute-dtype
        images read by the forward and the backward and written by the
        upload, and the f32 grads read by the download. Otherwise, or for a
        model without
        ``flops_per_token``: the reference's fallback ``6 * N * tokens``
        with no bytes. The parameter and state sizes are counted once."""
        flops, nbytes = 0.0, 0.0
        if tokens:
            if self._param_counts is None:
                params = tree_leaves(self.state.params)
                self._param_counts = (
                    sum(t.numel() for t in params),
                    sum(t.numel() * t.element_size() for t in
                        params + tree_leaves(self.state.opt_state)
                        if isinstance(t, torch.Tensor)))
            numel, state_bytes = self._param_counts
            if (self.config.telemetry_config.cost_analysis
                    and hasattr(self.module, "flops_per_token")):
                kw = {} if ltd_keep is None else {"ltd_keep": ltd_keep}
                flops = float(self.module.flops_per_token(seq, **kw)) * tokens
                itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
                if self._host_opt is not None:
                    nbytes = (3.0 * itemsize + 4.0) * numel
                else:
                    nbytes = 2.0 * state_bytes + 2.0 * itemsize * numel
            else:
                flops = 6.0 * numel * tokens
        self._telemetry_flops = flops
        self._telemetry_bytes = nbytes
        return flops or None

    def train_step_attribution(self) -> dict:
        """The train step's roofline row (telemetry/attribution.py): the
        counted FLOPs and bytes (of the last step) joined with
        the fence-measured device step time and the card's roofs; also
        written to the telemetry sink as an ``{"kind": "attribution",
        "scope": "train"}`` record."""
        flops = self._telemetry_flops
        if not flops:
            return {}
        wall_s = None
        if self.telemetry is not None:
            ms = self.telemetry.gauge("train/device_step_time_ms").value
            if ms:
                wall_s = ms / 1e3
        peak_flops, peak_bw = accelerator_peaks(self.accelerator.device_name())
        row = roofline_row(flops, self._telemetry_bytes or 0.0,
                           wall_s=wall_s, calls=self.global_steps,
                           peak_flops=peak_flops, peak_bytes_per_sec=peak_bw)
        table = {"train_step": row}
        if self.telemetry is not None and self.telemetry.sink is not None:
            self.telemetry.sink.write({"kind": "attribution",
                                       "scope": "train", "programs": table})
        return table

    # ----------------------------------------------------------- resilience
    def _resilience_step(self, loss, metrics, batch) -> None:
        """Per-step sentinel bookkeeping (the reference's). The step's
        loss, grad norm and overflow flag queue as one small device tensor;
        classification happens at the check fence (one device-to-host copy
        for every queued step). Auto-checkpoints are screened: the sentinel
        drains BEFORE a save so a detected-late anomaly can never be
        published as a rewind target."""
        rcfg = self.resilience_config
        flag = metrics["overflow"]
        self._pending_anomaly_reads.append((self.global_steps, torch.stack(
            [loss.float(), metrics["grad_norm"].float(),
             (flag if flag is not None else self._no_overflow).float()])))
        save_due = bool(rcfg.checkpoint_dir is not None
                        and rcfg.checkpoint_interval
                        and self.global_steps % rcfg.checkpoint_interval == 0)
        # an SDC-armed run audits BEFORE every save too: a bit flipped
        # between audits must never be published into a rewind target
        audit_due = bool(rcfg.sdc_audit_interval) and (
            save_due or self.global_steps % rcfg.sdc_audit_interval == 0)
        replay_due = bool(rcfg.step_replay_interval
                          and self.global_steps % rcfg.step_replay_interval == 0)
        if not (save_due or audit_due or replay_due
                or self.global_steps % self._sentinel_interval == 0):
            return
        anomaly = self._sentinel_drain()
        if anomaly is None and audit_due:
            anomaly = self._sdc_audit_check()
        if anomaly is None and replay_due:
            anomaly = self._sdc_step_replay_check(batch)
        if self.slo is not None:
            # SLO judgment at the sentinel's fence: the training SLIs read
            # gauges / counters the fence just refreshed (host only)
            self.slo.maybe_evaluate()
        if anomaly is not None:
            self._recover_or_raise(anomaly)
            return
        # de-escalate the skip width only once training has cleanly passed
        # the last anomaly's region — a clean check while still replaying
        # toward it must not shrink the next escalation
        if self.global_steps > self._last_anomaly_step:
            self._rewinds_since_clean = 0
        if save_due:
            self.save_checkpoint(rcfg.checkpoint_dir)

    def _sentinel_drain(self):
        """Classify every queued step; returns the first *actionable*
        anomaly (overflows are counted but the loss scaler already handled
        them). Entries after an actionable anomaly are dropped — they ran
        on suspect params and the rewind re-executes them anyway."""
        from deepspeed_tpu_torch.runtime.sentinel import AnomalyClass

        if not self._pending_anomaly_reads:
            return None
        t0 = time.perf_counter() if self.tracer is not None else 0.0
        pending, self._pending_anomaly_reads = \
            self._pending_anomaly_reads, []
        # the sentinel's fence: ONE copy of every queued step's scalars
        vals = torch.stack([v for _, v in pending]).tolist()
        reg = self.telemetry
        found = None
        for (step, _), (loss, norm, ovf) in zip(pending, vals):
            a = self.sentinel.observe(step, loss, norm, bool(ovf))
            if a is None:
                continue
            if reg is not None:
                reg.counter(f"resilience/anomalies_{a.cls}").inc()
            if a.cls != AnomalyClass.OVERFLOW:
                found = a
                break
        if self.tracer is not None:
            self.tracer.record(
                "sentinel_check", t0, time.perf_counter(),
                trace_id=self._train_trace, observations=len(pending),
                step=self.global_steps,
                anomaly=(found.cls if found is not None else None))
        return found

    def _sdc_audit_check(self):
        """Cross-replica checksum agreement over params + optimizer state
        (runtime/sentinel.py ``sdc_audit``). A mismatch quarantines the
        suspect device — counted, evented, and surfaced to the elastic
        agent via ``set_sdc_quarantine_callback`` — and returns an SDC
        anomaly so recovery rewinds. On the port's one device every leaf
        has one copy: the audit compares no group and reads ok."""
        from deepspeed_tpu_torch.runtime.sentinel import (AnomalyClass,
                                                          TrainingAnomaly,
                                                          sdc_audit)

        res = sdc_audit({"params": self.state.params,
                         "opt_state": self.state.opt_state})
        reg = self.telemetry
        if reg is not None:
            reg.counter("resilience/sdc_audits").inc()
        if res.ok:
            self.sdc_suspect_devices = ()  # healed / transient: un-flag
            return None
        self.sdc_suspect_devices = res.suspects
        if reg is not None:
            reg.counter("resilience/sdc_mismatches").inc()
        record_event("resilience/sdc_quarantine", step=self.global_steps,
                     suspect_devices=list(res.suspects),
                     mismatched_groups=res.mismatched_groups)
        logger.error(
            "SDC audit: %d/%d replica groups disagree; suspect device(s) "
            "%s quarantined", res.mismatched_groups, res.n_groups,
            list(res.suspects))
        if self._sdc_quarantine_cb is not None:
            try:
                self._sdc_quarantine_cb(res)
            except Exception as e:
                logger.warning("sdc quarantine callback failed: %s", e)
        detail = (f"{res.mismatched_groups}/{res.n_groups} replica groups "
                  f"disagree; suspects {list(res.suspects)}")
        return TrainingAnomaly(AnomalyClass.SDC, self.global_steps,
                               float(res.mismatched_groups), 0.0, detail)

    def set_sdc_quarantine_callback(self, cb) -> None:
        """Hook for the elastic agent / launcher: called with the
        :class:`~deepspeed_tpu_torch.runtime.sentinel.SDCAuditResult` when
        an audit finds a deviating replica, so the supervisor can exclude
        the host from the next worker group."""
        self._sdc_quarantine_cb = cb

    def set_slo(self, slo) -> None:
        """Attach an :class:`~deepspeed_tpu_torch.telemetry.slo.SLOEngine`:
        the training SLIs (``train_mfu`` floor, ``train_anomaly_rate``) are
        evaluated at the sentinel's check fence, where the gauges and
        counters they read were just refreshed. Requires the resilience
        sentinel to be armed (the fence is the evaluation site); raises
        otherwise so a misconfigured job fails loudly instead of silently
        never judging."""
        if slo is not None and self.sentinel is None:
            raise ValueError(
                "set_slo needs the resilience sentinel armed "
                "(resilience.enabled): SLO evaluation rides the "
                "sentinel's check fence")
        self.slo = slo

    def _sdc_step_replay_check(self, batch):
        """Single-device determinism probe (runtime/sentinel.py
        ``step_replay_probe``): :meth:`_train_step` on the current state and
        the step's batch, run twice on clones of the state, each replay
        with the dropout generator at the same state, must agree bit for
        bit; a mismatch is flaky hardware (counted + evented, recovered
        like SDC). The live state and the generator are as they were
        after. Skipped under the host optimizer, PLD and random-LTD, as
        the reference skips it."""
        from deepspeed_tpu_torch.runtime.sentinel import (AnomalyClass,
                                                          TrainingAnomaly,
                                                          step_replay_probe)

        if self._host_opt is not None or self._use_pld or self._use_random_ltd:
            return None
        lr = self.get_lr()[0]
        gen_state = self._dropout_rng.get_state()

        def replay(state):
            self._dropout_rng.set_state(gen_state)
            return self._train_step(state, batch, lr)

        try:
            ok, detail = step_replay_probe(replay, self.state)
        finally:
            self._dropout_rng.set_state(gen_state)
        reg = self.telemetry
        if reg is not None:
            reg.counter("resilience/step_replays").inc()
        if ok:
            return None
        if reg is not None:
            reg.counter("resilience/step_replay_mismatches").inc()
        record_event("resilience/step_replay_mismatch",
                     step=self.global_steps, detail=detail)
        logger.error("step-replay probe: %s", detail)
        return TrainingAnomaly(AnomalyClass.REPLAY, self.global_steps,
                               0.0, 0.0, detail)

    def _recover_or_raise(self, anomaly) -> None:
        """PaLM-style rewind-and-skip: reload the newest *valid* checkpoint
        (the checkpoint engine's walk-back survives a tag corrupted
        mid-recovery), restore the dataloader position from its
        ``__meta__``, then fast-forward past the offending batch window —
        the batches between the rewind target and the anomaly, plus an
        extra width that escalates across back-to-back rewinds. SDC/replay
        anomalies skip nothing (the data was fine): they rewind and
        deterministically replay. Bounded by the rolling rewind budget so
        a poisoned shard cannot livelock."""
        from deepspeed_tpu_torch.runtime.sentinel import (AnomalyClass,
                                                          RewindBudgetExceededError,
                                                          TrainingAnomalyError)

        rcfg = self.resilience_config
        record_event("resilience/anomaly", cls=anomaly.cls,
                     step=anomaly.step, value=anomaly.value,
                     zscore=round(anomaly.zscore, 2), detail=anomaly.detail)
        if self.flight_recorder is not None:
            # freeze the pre-incident window BEFORE recovery rewinds
            # state — the dump is the postmortem of what training saw
            # at detection, not of the already-healed timeline
            self.flight_recorder.trigger(
                "training_anomaly", cls=anomaly.cls, step=anomaly.step,
                value=anomaly.value, zscore=round(anomaly.zscore, 2),
                detail=anomaly.detail)
        logger.warning("training anomaly: %s at step %d (%s)",
                       anomaly.cls, anomaly.step, anomaly.detail)
        dl = self.training_dataloader
        recoverable = (rcfg.on_anomaly == "recover"
                       and rcfg.checkpoint_dir is not None
                       # the engine-owned loader must be the LIVE source:
                       # rewinding it while a caller-supplied iterator
                       # keeps advancing would silently desync data from
                       # params — raise instead
                       and self._engine_owned_stream
                       and dl is not None
                       and hasattr(dl, "load_state_dict")
                       and getattr(dl, "supports_deterministic_resume",
                                   lambda: True)())
        if not recoverable:
            raise TrainingAnomalyError(anomaly)
        t0 = time.perf_counter()
        spent = self._rewind_budget.record()
        if spent > rcfg.max_rewinds:
            record_event("resilience/rewind_budget_exhausted",
                         spent=spent, budget=rcfg.max_rewinds)
            raise RewindBudgetExceededError(
                anomaly, f"rewind budget exhausted: {spent} rewinds "
                         f"(budget {rcfg.max_rewinds}"
                         + (f" in {rcfg.rewind_window_s}s"
                            if rcfg.rewind_window_s else "")
                         + f"); last anomaly: {anomaly.cls} at step "
                           f"{anomaly.step}")
        # rewind: the walk-back to the newest valid tag; raises the typed
        # CheckpointCorruptionError loudly if every tag is invalid
        it_before = self._train_iter
        path, _ = self.load_checkpoint(rcfg.checkpoint_dir)
        if path is None:
            raise TrainingAnomalyError(
                anomaly, f"anomaly at step {anomaly.step} but no checkpoint "
                         f"under {rcfg.checkpoint_dir} to rewind to")
        if it_before is not None and self._train_iter is it_before:
            # the loaded tag carried no restorable dataloader state (saved
            # before the loader was attached, or by another writer): params
            # are rewound but the data stream is NOT — fast-forwarding the
            # stale iterator would silently desync data from params
            raise TrainingAnomalyError(
                anomaly, f"rewound params to {path}, but that checkpoint "
                         f"has no dataloader state — cannot rewind the "
                         f"data stream deterministically; re-save "
                         f"checkpoints with this engine to enable "
                         f"auto-recovery")
        rewound_to = self.global_steps
        self._rewinds_since_clean += 1
        self._last_anomaly_step = anomaly.step
        if anomaly.cls in AnomalyClass.DATA_CLASSES:
            extra = min(rcfg.skip_width_base * rcfg.skip_width_factor
                        ** (self._rewinds_since_clean - 1),
                        rcfg.skip_width_max)
            skip_steps = max(anomaly.step - rewound_to, 0) + extra
        else:  # sdc/replay: the data was fine — replay it
            skip_steps = 0
        n_batches = skip_steps * self.gas
        it = self._ensure_train_iter()  # load invalidated the old iterator
        for _ in range(n_batches):
            next(it)
        # sentinel history is kept: the rewind RESTORES the pre-anomaly
        # regime, so that history is the correct baseline for the replayed
        # steps. (The anomalous value itself was never pushed.)
        self._pending_anomaly_reads.clear()
        dt_ms = (time.perf_counter() - t0) * 1e3
        rec = {"class": anomaly.cls, "anomaly_step": anomaly.step,
               "rewound_to": rewound_to, "skipped_steps": skip_steps,
               "skipped_batches": n_batches, "checkpoint": path,
               "recovery_ms": round(dt_ms, 2)}
        self.rewind_log.append(rec)
        reg = self.telemetry
        if reg is not None:
            reg.counter("resilience/rewinds").inc()
            if n_batches:
                reg.counter("resilience/skipped_batches").inc(n_batches)
            reg.histogram("resilience/recovery_latency_ms").observe(dt_ms)
        if self.tracer is not None:
            self.tracer.record(
                "recovery", t0, time.perf_counter(),
                trace_id=self._train_trace, anomaly=anomaly.cls,
                anomaly_step=anomaly.step, rewound_to=rewound_to,
                skipped_batches=n_batches)
        record_event("resilience/rewind", **rec)
        log_dist(
            f"anomaly recovery: {anomaly.cls} at step {anomaly.step} -> "
            f"rewound to step {rewound_to} ({path}), skipping "
            f"{n_batches} batch(es) ({skip_steps} step(s)), "
            f"{dt_ms:.0f} ms", ranks=[0])

    def install_preemption_handler(self, save_dir, tag=None, defer=None,
                                   **handler_kw):
        """SIGTERM (a maintenance / preemption notice) -> final synchronous
        checkpoint to ``save_dir`` -> exit with the restartable preemption
        code, which the elastic agent restarts without burning budget.
        Returns the installed handler (also usable as a maintenance-event
        callback via ``handler.trigger()``); with ``defer=True`` the notice
        only flags and the engine performs the save at the next step
        boundary.

        The port runs one process, so ``defer`` defaults to False (the
        reference's single-host default): a notice between steps saves at
        once. A notice that lands inside a step (after ``train_batch``
        pulled its batches, or while the optimizer updates the state in
        place, leaf by leaf) is deferred all the same, to the poll at the
        end of that step, so the tag never pairs half-updated state or a
        loader ahead of its parameters. The reference's multi-host
        ``consensus_fn`` (a per-step vote across processes, so every host
        starts the save at one step boundary) waits for the port's
        ``comm/``; a caller may pass its own."""
        from deepspeed_tpu_torch.elasticity.preemption import PreemptionHandler

        def final_save():
            self.save_checkpoint(save_dir, tag=tag)
            ck = self._checkpoint_engine()
            if ck is not None and hasattr(ck, "wait"):
                ck.wait()  # async engine: durable before the process dies

        self._preemption_handler = PreemptionHandler(
            final_save, defer=bool(defer), busy_fn=lambda: self._in_step,
            **handler_kw).install()
        return self._preemption_handler

    def destroy(self) -> None:
        """Flush telemetry and close and detach the sinks this engine
        owns (reference engine.destroy)."""
        if self.telemetry is not None:
            self.telemetry.flush(step=self.global_steps)
        if self._spans_sink is not None:
            self._spans_sink.close()
            self._spans_sink = None
        if self._owned_sink is not None:
            self._owned_sink.close()
            self._owned_sink = None
        if self._attached_sink is not None:
            if self.telemetry is not None \
                    and self.telemetry.sink is self._attached_sink:
                self.telemetry.attach_sink(None)
            self._attached_sink = None

    # ------------------------------------------ forward/backward/step parity
    def forward(self, batch):
        """Loss of one micro-batch; its graph is kept for backward()."""
        if self._path_t0 is None:
            self._path_t0 = time.perf_counter()
        tokens, self._path_seq = self._batch_token_count(batch)
        self._path_tokens += tokens
        self._timer(FORWARD_GLOBAL_TIMER, True)
        loss, scaled, leaves = self._micro_loss(self.state,
                                                self._to_device(batch))
        self._timer(FORWARD_GLOBAL_TIMER, False)
        self._pending = (scaled, leaves, loss.detach())
        return loss.detach()

    __call__ = forward

    def backward(self, loss=None, allreduce_gradients: bool = True):
        """Accumulate the pending micro-batch's grads (reference backward)."""
        assert self._pending is not None, "backward() must follow forward()"
        scaled, leaves, self._path_loss = self._pending
        self._pending = None
        self._timer(BACKWARD_GLOBAL_TIMER, True)
        scaled.backward()
        self._grad_acc = self._accumulate(leaves, self._grad_acc)
        self._timer(BACKWARD_GLOBAL_TIMER, False)
        self._acc_count += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return (self.micro_steps + 1) % self.gas == 0

    def step(self):
        """Apply the optimizer at the gas boundary (reference step). A
        preemption notice that lands inside the update is served at the
        poll after it."""
        boundary = self.is_gradient_accumulation_boundary()
        with self._step_in_flight():
            if boundary:
                self._boundary_step()
            self.micro_steps += 1
        if boundary:
            self._poll_preemption()

    def _boundary_step(self) -> None:
        """step()'s update at the gas boundary."""
        assert self._acc_count == self.gas, (
            f"step() at boundary needs {self.gas} backward() calls, "
            f"got {self._acc_count}")
        self._timer(STEP_GLOBAL_TIMER, True)
        if self._host_opt is not None:
            self._host_apply(self.get_lr()[0])
        else:
            # / gas in the accumulation dtype, as the reference's step()
            grads = tree_map(lambda g: g / self.gas, self._take_grads())
            self.state, metrics = self._apply_grads(self.state, grads,
                                                    self.get_lr()[0])
            self.skipped_steps += int(metrics["skipped"])
            self._global_grad_norm = metrics["grad_norm"]
        self._timer(STEP_GLOBAL_TIMER, False)
        self._acc_count = 0
        self._finish_step()
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        if self.telemetry is not None:
            # the reference's forward/backward/step path records none;
            # here it counts like a train_batch step (the last
            # micro-batch's loss stands for the step's)
            self._record_step_telemetry(
                self._path_loss, self._path_tokens, self._path_seq,
                time.perf_counter() - self._path_t0)
        self._path_tokens, self._path_t0 = 0, None

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
    def _checkpoint_engine(self):
        """Engine-lifetime checkpoint backend: the background-thread engine
        under ``checkpoint.async_save``, else None (a native engine per
        call), as the reference chooses."""
        if getattr(self, "_ckpt_engine", None) is None:
            if self.config.checkpoint_config.async_save:
                from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
                    AsyncCheckpointEngine)

                self._ckpt_engine = AsyncCheckpointEngine()
            else:
                self._ckpt_engine = None
        return self._ckpt_engine

    def _checkpoint_span(self, name: str, t0: float) -> None:
        """The ``checkpoint_save`` / ``checkpoint_load`` span, and a fresh
        telemetry window: the checkpoint's time is not a step's."""
        if self.tracer is not None:
            self.tracer.record(name, t0, time.perf_counter(),
                               trace_id=self._train_trace,
                               step=self.global_steps)
        if self.telemetry is not None:
            self._reset_telemetry_window()

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Write ``<save_dir>/<tag>/state.npz`` and its sidecars in the
        reference's format (runtime/checkpoint_engine/engine.py)."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import save_engine_checkpoint

        t0 = time.perf_counter()
        try:
            return save_engine_checkpoint(self, save_dir, tag=tag,
                                          client_state=client_state,
                                          save_latest=save_latest,
                                          checkpoint_engine=self._checkpoint_engine())
        finally:
            self._checkpoint_span("checkpoint_save", t0)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True, load_module_only=False):
        """Load ``tag`` (default: the newest valid one, walking back past
        corrupt tags) onto this engine's device; returns ``(path,
        client_state)``."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import load_engine_checkpoint

        t0 = time.perf_counter()
        try:
            return load_engine_checkpoint(self, load_dir, tag=tag,
                                          load_optimizer_states=load_optimizer_states,
                                          load_lr_scheduler_states=load_lr_scheduler_states,
                                          load_module_only=load_module_only,
                                          checkpoint_engine=self._checkpoint_engine())
        finally:
            self._checkpoint_span("checkpoint_load", t0)

    def save_16bit_model(self, save_dir, save_filename="model_weights.npz"):
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import save_16bit_model

        return save_16bit_model(self, save_dir, save_filename)
