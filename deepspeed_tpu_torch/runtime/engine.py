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
``steps_per_print`` steps.
"""

from __future__ import annotations

import time
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
from deepspeed_tpu_torch.telemetry import (FlightRecorder, JsonlSink,
                                           SpanTracer, accelerator_peaks,
                                           get_registry, mfu, roofline_row)
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER,
                                             FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER,
                                             TRAIN_BATCH_TIMER,
                                             SynchronizedWallClockTimer)
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

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
        # the forward/backward/step path's tokens and start since the last
        # boundary (its step telemetry)
        self._path_tokens = 0
        self._path_seq = 0
        self._path_t0: Optional[float] = None
        self._path_loss = None

        # ---- wall-clock breakdown: CUDA-event timers, read at the log
        self.timers = (SynchronizedWallClockTimer(self.device)
                       if config.wall_clock_breakdown else None)
        self._init_telemetry(config.telemetry_config)

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
    def _init_telemetry(self, tcfg) -> None:
        """The registry, the owned JSONL sink, the span tracer and the
        flight recorder's tee, as the reference arms them."""
        self.telemetry = None
        self._telemetry_flops: Optional[float] = None   # None: not counted
        self._telemetry_bytes: Optional[float] = None
        self._fence_t: Optional[float] = None
        self._fence_step = 0
        self._fence_tokens = 0
        self._owned_sink = None
        self.tracer = None
        self._train_trace = None
        self._spans_sink = None
        self.flight_recorder = None
        self.slo = None
        self.sentinel = None          # the resilience sentinel: not ported
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
        tokens, seq = self._batch_token_count(batch)
        batch = self._to_device(batch)
        loss_sum = None
        for i in range(self.gas):
            mb = tree_map(lambda x: x[i], batch) if isinstance(batch, dict) else batch[i]
            self._timer(FORWARD_GLOBAL_TIMER, True)
            loss, scaled, leaves = self._micro_loss(mb)
            self._timer(FORWARD_GLOBAL_TIMER, False)
            self._timer(BACKWARD_GLOBAL_TIMER, True)
            scaled.backward()
            self._accumulate(leaves)
            self._timer(BACKWARD_GLOBAL_TIMER, False)
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        self._timer(STEP_GLOBAL_TIMER, True)
        grads, self._grad_acc = self._grad_acc, None
        grads = tree_map(lambda g: g.float() / self.gas, grads)
        self._apply_grads(grads, lr)
        self._timer(STEP_GLOBAL_TIMER, False)
        self.micro_steps += self.gas
        self._finish_step()
        loss = loss_sum / self.gas
        self._timer(TRAIN_BATCH_TIMER, False)
        if self.telemetry is not None:
            self._record_step_telemetry(loss, tokens, seq,
                                        time.perf_counter() - t_start)
        self._log_step(loss)
        return loss

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
                               wall_dt: float) -> None:
        """Per step: two counters and a histogram observation; everything
        that needs the device waits for the periodic fence."""
        reg = self.telemetry
        reg.counter("train/steps").inc()
        if tokens:
            self._fence_tokens += tokens
            reg.counter("train/tokens").inc(tokens)
        reg.histogram("train/step_wall_ms").observe(wall_dt * 1e3)
        interval = self.config.telemetry_config.sync_interval
        if interval and (self.global_steps % interval == 0
                         or self.global_steps == 1):
            self._telemetry_fence(loss, tokens, seq)

    def _reset_telemetry_window(self) -> None:
        """Drop the fence-to-fence baseline, so that work between fences
        that is not training steps is not charged to the device rate."""
        self._fence_t = None
        self._fence_step = self.global_steps
        self._fence_tokens = 0

    def _telemetry_fence(self, loss, tokens: int, seq: int) -> None:
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
            flops = self._telemetry_flops
            if flops:
                reg.gauge("train/model_tflops").set(flops / dev_step_s / 1e12)
                u = mfu(flops, dev_step_s, 1, self.accelerator.device_name())
                if u is not None:
                    reg.gauge("train/mfu").set(u)
        self._train_step_flops(tokens, seq)
        self._fence_step = self.global_steps
        self._fence_tokens = 0
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

    def _train_step_flops(self, tokens: int, seq: int) -> Optional[float]:
        """FLOPs of one train step, counted once. ``cost_analysis`` true:
        ``model.flops_per_token(seq) * tokens`` (forward, backward and the
        attention term; chip_smoke's train_774m counts the same), with the
        step's bytes the update's traffic: every f32 master parameter and
        optimizer-state tensor read and written once, and the compute-dtype
        weights read once by the forward and once by the backward (a lower
        bound: activations are left out). Otherwise, or for a model without
        ``flops_per_token``: the reference's fallback ``6 * N * tokens``
        with no bytes."""
        if self._telemetry_flops is not None:
            return self._telemetry_flops or None
        flops, nbytes = 0.0, 0.0
        if tokens:
            params = tree_leaves(self.state.params)
            if (self.config.telemetry_config.cost_analysis
                    and hasattr(self.module, "flops_per_token")):
                flops = float(self.module.flops_per_token(seq)) * tokens
                state_bytes = sum(t.numel() * t.element_size() for t in
                                  params + tree_leaves(self.state.opt_state)
                                  if isinstance(t, torch.Tensor))
                itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
                nbytes = 2.0 * state_bytes + 2.0 * itemsize * sum(
                    t.numel() for t in params)
            else:
                flops = 6.0 * sum(t.numel() for t in params) * tokens
        self._telemetry_flops = flops
        self._telemetry_bytes = nbytes
        return flops or None

    def train_step_attribution(self) -> dict:
        """The train step's roofline row (telemetry/attribution.py): the
        counted FLOPs and bytes (counted at the first fence) joined with
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

    def set_slo(self, slo) -> None:
        """Attach an SLO engine, evaluated at the resilience sentinel's
        check fence. The sentinel is not ported, so any engine raises, as
        the reference does without a sentinel."""
        if slo is not None and self.sentinel is None:
            raise ValueError(
                "set_slo needs the resilience sentinel armed "
                "(resilience.enabled): SLO evaluation rides the "
                "sentinel's check fence")
        self.slo = slo

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
        loss, scaled, leaves = self._micro_loss(self._to_device(batch))
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
        self._accumulate(leaves)
        self._timer(BACKWARD_GLOBAL_TIMER, False)
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
            self._timer(STEP_GLOBAL_TIMER, True)
            grads, self._grad_acc = self._grad_acc, None
            # / gas in the accumulation dtype, as the reference's step()
            grads = tree_map(lambda g: g / self.gas, grads)
            self._apply_grads(grads, self.get_lr()[0])
            self._timer(STEP_GLOBAL_TIMER, False)
            self._acc_count = 0
            self._finish_step()
            if self.telemetry is not None:
                # the reference's forward/backward/step path records none;
                # here it counts like a train_batch step (the last
                # micro-batch's loss stands for the step's)
                self._record_step_telemetry(
                    self._path_loss, self._path_tokens, self._path_seq,
                    time.perf_counter() - self._path_t0)
            self._path_tokens, self._path_t0 = 0, None
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
