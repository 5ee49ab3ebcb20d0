"""ZeRO-Offload / ZeRO-Infinity host optimizer (port of
deepspeed_tpu/runtime/zero/offload.py) for one process.

The f32 masters and the optimizer's moments live in host memory (pageable
torch CPU tensors, 12 bytes a parameter under Adam) or, with
``device="nvme"``, on storage in per-parameter sub-groups swapped in and
out around each sub-group's update by ``PipelinedOptimizerSwapper``
(read, step and write-back overlapped). The card keeps only the
compute-dtype image of each parameter. Each step the engine's f32 grads
(divided by gas and unscaled on the card) come down, the native kernel
updates the state on the host (ops/cpu_adam_native.py; Adam and AdamW in
one fused sweep that scales the grad by ``grad_scale``, the clip factor,
and writes the bf16 image), and the images go up.

On the card the grads and images move through a ring of pinned staging
slots of ``CHUNK`` elements, allocated once: the download of the next
chunks (a side stream, ``non_blocking``) and the upload of the last ones
(another) overlap the host kernel on this one, and the host waits on each
slot's event before the kernel reads or overwrites it. Adam is
elementwise, so a chunk's update is the leaf's, bit for bit. Only the
staging slots are pinned, never the state.

``step`` also takes host grads and returns host images, as the
reference's does (the CPU engine and the tests). Nothing falls back: a
missing compiler or a failed build of the kernels raises when the
optimizer is made (the reference falls back to numpy).

What waits: the reference's multi-host shard path (``_ShardMeta``,
``DSTPU_FORCE_SHARD_OFFLOAD``: each process keeps only its unique
addressable shards) has no meaning on one rank; it waits for the port's
multi-rank slice (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops import cpu_adam_native as cna

_ADAM = ("adam", "cpu_adam")
CHUNK = 1 << 24     # elements a staging slot holds (64 MB of f32 grad)
SLOTS = 4
STAT_KEYS = ("download_wait_s", "adam_s", "upload_wait_s", "step_s",
             "bytes_swept", "nvme_read_bytes", "nvme_write_bytes")


def param_names(tree) -> Dict[str, Any]:
    """A parameter tree's leaves keyed as ``jax.tree_util.keystr`` names
    them (``"['blocks']['wq']"``), in the reference's (sorted-key) order:
    the host state's names, in memory and in checkpoints."""
    out: Dict[str, Any] = {}
    _walk_names(tree, "", out)
    return out


def _walk_names(node, prefix: str, out: Dict[str, Any]) -> None:
    # a module-level function: a nested recursive closure would hold ``out``
    # (every leaf, grads included) in a reference cycle until gc runs
    if isinstance(node, dict):
        for k in sorted(node):
            _walk_names(node[k], f"{prefix}[{k!r}]", out)
    else:
        out[prefix] = node


class _HostTransfer:
    """Host grads and images: each task's chunk is read and written in
    place."""

    def run(self, tasks, update, stats) -> None:
        for src, dst, a, b, ctx in tasks:
            t0 = time.perf_counter()
            update(ctx, a, b, src[a:b], dst[a:b])
            stats["adam_s"] += time.perf_counter() - t0

    def finish(self, stats) -> None:
        pass


class CardStaging:
    """The pinned ring between the card and the host kernel: f32 grad
    slots filled on a download stream, compute-dtype image slots drained
    on an upload stream, each with its event."""

    def __init__(self, device: torch.device, img_dtype: torch.dtype):
        self.device = device
        self.chunk = CHUNK
        self.grad = [torch.empty(CHUNK, dtype=torch.float32, pin_memory=True)
                     for _ in range(SLOTS)]
        self.img = [torch.empty(CHUNK, dtype=img_dtype, pin_memory=True)
                    for _ in range(SLOTS)]
        self.down = torch.cuda.Stream(device)
        self.up = torch.cuda.Stream(device)
        self.down_ev = [torch.cuda.Event() for _ in range(SLOTS)]
        self.up_ev = [torch.cuda.Event() for _ in range(SLOTS)]
        self.up_busy = [False] * SLOTS

    def run(self, tasks, update, stats) -> None:
        cur = torch.cuda.current_stream(self.device)
        # the grads are written, and the params last read, on this stream
        self.down.wait_stream(cur)
        self.up.wait_stream(cur)
        n, slots = len(tasks), len(self.grad)
        issued = 0
        for j in range(n):
            # a slot's grad is free once the host kernel of the task before
            # it in the ring has run: issue up to slots - 1 chunks ahead
            while issued < min(n, j + slots):
                src, _, a, b, _ = tasks[issued]
                s = issued % slots
                with torch.cuda.stream(self.down):
                    self.grad[s][:b - a].copy_(src[a:b], non_blocking=True)
                    self.down_ev[s].record(self.down)
                issued += 1
            _, dst, a, b, ctx = tasks[j]
            s, k = j % slots, b - a
            t0 = time.perf_counter()
            self.down_ev[s].synchronize()
            t1 = time.perf_counter()
            if self.up_busy[s]:
                self.up_ev[s].synchronize()
            t2 = time.perf_counter()
            update(ctx, a, b, self.grad[s][:k], self.img[s][:k])
            t3 = time.perf_counter()
            with torch.cuda.stream(self.up):
                dst[a:b].copy_(self.img[s][:k], non_blocking=True)
                self.up_ev[s].record(self.up)
            self.up_busy[s] = True
            stats["download_wait_s"] += t1 - t0
            stats["upload_wait_s"] += t2 - t1
            stats["adam_s"] += t3 - t2

    def finish(self, stats) -> None:
        """The step ends with its images on the card; later work on the
        current stream is ordered after the uploads."""
        t0 = time.perf_counter()
        self.up.synchronize()
        stats["upload_wait_s"] += time.perf_counter() - t0
        self.up_busy = [False] * len(self.up_busy)
        torch.cuda.current_stream(self.device).wait_stream(self.up)

    def pinned(self) -> bool:
        return all(t.is_pinned() for t in self.grad + self.img)


class HostOffloadOptimizer:
    """Host-resident Adam / AdamW / Adagrad state, optionally on NVMe.

    Unlike the device optimizers, the state lives inside this object:
    ``init(params)`` takes the f32 masters, ``step(grads, lr, grad_scale,
    out)`` updates them and writes the compute-dtype images."""

    def __init__(self, optimizer, offload_config, compute_dtype: torch.dtype):
        self.opt = optimizer
        self.compute_dtype = compute_dtype
        device = getattr(offload_config, "device", "cpu")
        self.device = getattr(device, "value", device)
        self.kind = getattr(optimizer, "name", "adam")
        if self.kind not in _ADAM + ("adagrad",):
            raise ValueError(
                f"host offload supports adam/adamw/adagrad, got '{self.kind}'")
        # built here, so that a missing compiler raises before training; the
        # sweeps' OpenMP team is one thread a usable core, set explicitly
        # (torch's own intra-op pool is idle while the host step runs)
        cna.load()
        self.num_threads = cna.set_num_threads(len(os.sched_getaffinity(0)))
        self.step_count = 0
        self.master: Dict[str, torch.Tensor] = {}
        self.moments: Dict[str, Dict[str, torch.Tensor]] = {}
        self._names: List[str] = []
        self._shapes: Dict[str, tuple] = {}
        self.staging: Optional[CardStaging] = None
        self.stats = dict.fromkeys(STAT_KEYS, 0.0)
        self._swapper = None
        self._swap_names = ["master"] + list(self._zero_moments(torch.empty(0)))
        self.swap_folder = None
        if self.device == "nvme":
            # a per-run folder by default: a fixed shared one would let two
            # jobs overwrite each other's state
            self.swap_folder = getattr(offload_config, "nvme_path", None) or \
                tempfile.mkdtemp(prefix="dstpu_nvme_swap_")
            from deepspeed_tpu_torch.runtime.swap_tensor import PipelinedOptimizerSwapper

            self._swapper = PipelinedOptimizerSwapper(self.swap_folder)

    # ------------------------------------------------------------------ init
    def init(self, params) -> None:
        """Copy the parameters to host f32 masters and zero the moments
        (on storage under nvme). Re-initialising restarts the step count
        with the fresh moments."""
        self.step_count = 0
        flat = param_names(params)
        self._names = list(flat)
        self._shapes = {n: tuple(t.shape) for n, t in flat.items()}
        self.master, self.moments = {}, {}
        for i, (name, leaf) in enumerate(flat.items()):
            master = torch.empty(leaf.shape, dtype=torch.float32)
            master.copy_(leaf.detach())
            moments = self._zero_moments(master)
            if self._swapper is not None:
                self._swapper.swap_out_group(i, {"master": master, **moments})
            else:
                self.master[name] = master
                self.moments[name] = moments

    def _zero_moments(self, master: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.kind in _ADAM:
            return {"exp_avg": torch.zeros_like(master),
                    "exp_avg_sq": torch.zeros_like(master)}
        return {"sum_sq": torch.zeros_like(master)}

    # ------------------------------------------------------------------ step
    def step(self, grads: Dict[str, torch.Tensor], lr, grad_scale: float = 1.0,
             out: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """Update the masters in place from ``grads`` (by name) times
        ``grad_scale`` (the engine's clip factor) and write each
        compute-dtype image into ``out[name]`` (host or card tensors), or
        into new host tensors; returns the images."""
        t0 = time.perf_counter()
        self.step_count += 1
        lr = float(np.asarray(lr))
        self.stats = dict.fromkeys(STAT_KEYS, 0.0)
        if out is None:
            out = {n: torch.empty(self._shapes[n], dtype=self.compute_dtype)
                   for n in self._names}
        first = out[self._names[0]]
        xfer = self._card_staging(first.device) if first.device.type == "cuda" \
            else _HostTransfer()
        chunk = xfer.chunk if isinstance(xfer, CardStaging) else None

        def tasks(name, state):
            src = grads[name].detach()
            if first.device.type == "cuda" and src.dtype != torch.float32:
                src = src.float()
            src, dst = src.reshape(-1), out[name].view(-1)
            n = src.numel()
            step = chunk or max(n, 1)
            return [(src, dst, a, min(a + step, n), state)
                    for a in range(0, n, step)]

        update = self._update_fn(lr, grad_scale)
        if self._swapper is not None:
            sw = self._swapper.swapper
            r0, w0 = sw.bytes_read, sw.bytes_written

            def step_fn(g, state):
                xfer.run(tasks(self._names[g], state), update, self.stats)

            self._swapper.run_step(list(range(len(self._names))),
                                   self._swap_names, step_fn)
            self.stats["nvme_read_bytes"] = sw.bytes_read - r0
            self.stats["nvme_write_bytes"] = sw.bytes_written - w0
        else:
            work = []
            for name in self._names:
                work += tasks(name, {"master": self.master[name],
                                     **self.moments[name]})
            xfer.run(work, update, self.stats)
        xfer.finish(self.stats)
        self.stats["step_s"] = time.perf_counter() - t0
        return out

    def _card_staging(self, device) -> CardStaging:
        if self.staging is None:
            self.staging = CardStaging(device, self.compute_dtype)
        return self.staging

    def _update_fn(self, lr: float, grad_scale: float):
        """The kernel call on one chunk: ``(state, a, b, grad, image)``."""
        opt, step = self.opt, self.step_count
        stats = self.stats
        bf16 = self.compute_dtype == torch.bfloat16

        def update(state, a, b, g, img):
            master = state["master"].view(-1)[a:b]
            if self.kind in _ADAM:
                cna.adam_step_fused(
                    master, g, state["exp_avg"].view(-1)[a:b],
                    state["exp_avg_sq"].view(-1)[a:b], step=step, lr=lr,
                    betas=opt.betas, eps=opt.eps, weight_decay=opt.weight_decay,
                    adamw_mode=getattr(opt, "adam_w_mode", True),
                    bias_correction=getattr(opt, "bias_correction", True),
                    grad_scale=grad_scale, emit_bf16=bf16,
                    out=img if bf16 else None)
                moved = 24
            else:
                g32 = g.float()
                if grad_scale != 1.0:
                    g32 = g32 * float(np.float32(grad_scale))
                cna.adagrad_step(master, g32.contiguous(),
                                 state["sum_sq"].view(-1)[a:b], lr=lr,
                                 eps=opt.eps, weight_decay=opt.weight_decay)
                moved = 16
                if bf16:
                    cna.copy_f32_to_bf16(master, out=img)
            if not bf16:
                img.copy_(master)
            stats["bytes_swept"] += (b - a) * (moved + g.element_size()
                                               + img.element_size())

        return update

    # ----------------------------------------------------------- checkpoints
    def state_template(self) -> Dict[str, Any]:
        """The state tree's shapes and dtypes, reading nothing from storage
        (the checkpoint loader's template)."""
        out: Dict[str, Any] = {}
        for name in self._names:
            if self._swapper is not None:
                out[name] = {k: torch.empty(self._shapes[name])
                             for k in self._swap_names}
            else:
                out[name] = {"master": self.master[name], **self.moments[name]}
        return out

    def state_dict(self) -> Dict[str, Any]:
        if self._swapper is not None:
            state = {name: dict(self._swapper.swap_in_group(i, self._swap_names))
                     for i, name in enumerate(self._names)}
            return {"step": self.step_count, "state": state}
        return {"step": self.step_count,
                "state": {n: {"master": self.master[n], **self.moments[n]}
                          for n in self._names}}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step_count = int(sd["step"])
        for i, name in enumerate(self._names):
            entry = {k: torch.as_tensor(v).float().contiguous()
                     for k, v in sd["state"][name].items()}
            saved = tuple(entry["master"].shape)
            if saved != self._shapes[name]:
                raise ValueError(
                    f"offload checkpoint layout mismatch for {name!r}: saved "
                    f"master shape {saved} vs current {self._shapes[name]}; "
                    "the checkpoint was written for another model or "
                    "another shard layout")
            if self._swapper is not None:
                self._swapper.swap_out_group(i, entry)
            else:
                self.master[name] = entry.pop("master")
                self.moments[name] = entry
