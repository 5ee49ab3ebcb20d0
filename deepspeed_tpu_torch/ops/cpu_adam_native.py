"""The host optimizer kernels (port of deepspeed_tpu/ops/cpu_adam_native.py)
over ctypes: csrc/adam/dstpu_cpu_adam.cpp, built by ``ops/native/builder.py``.

They update contiguous torch CPU tensors in place: f32 masters and
moments; bf16 grads and images travel as their 16-bit patterns (the
kernel's ``uint16``), passed by ``data_ptr``. These are the ZeRO-Offload
host step's kernels (runtime/zero/offload.py).

Beside each kernel is its plain PyTorch version (``*_plain``), the same
operations in the same order in f32, which the tests hold the kernel to.
The kernel's compiler may fuse a multiply and an add, so the two agree to
an f32 rounding, not bit for bit. Nothing falls back to the plain
versions: a missing compiler or a failed build raises (the reference falls
back to numpy).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

_LIB: Optional[ctypes.CDLL] = None
_F = ctypes.c_float
_P = ctypes.c_void_p


def load() -> ctypes.CDLL:
    """The built library (built at the first call)."""
    global _LIB
    if _LIB is None:
        from deepspeed_tpu_torch.ops import CPUAdamNativeBuilder

        lib = CPUAdamNativeBuilder().load_library()
        lib.dstpu_adam_step.argtypes = [
            _P, _P, _P, _P, ctypes.c_uint64, ctypes.c_int64, _F, _F, _F, _F,
            _F, ctypes.c_int, ctypes.c_int]
        lib.dstpu_adam_step_fused.argtypes = [
            _P, _P, ctypes.c_int, _F, _P, _P, _P, ctypes.c_uint64,
            ctypes.c_int64, _F, _F, _F, _F, _F, ctypes.c_int, ctypes.c_int]
        lib.dstpu_adagrad_step.argtypes = [_P, _P, _P, ctypes.c_uint64, _F,
                                           _F, _F]
        lib.dstpu_copy_f32_to_bf16.argtypes = [_P, _P, ctypes.c_uint64]
        lib.dstpu_set_num_threads.argtypes = [ctypes.c_int]
        lib.dstpu_set_num_threads.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def set_num_threads(n: int = 0) -> int:
    """Set the OpenMP team size of the kernels' sweeps from this thread
    (``n <= 0`` leaves it); returns the size in force."""
    return load().dstpu_set_num_threads(int(n))


def _ptr(t: torch.Tensor, dtype=torch.float32) -> int:
    assert t.device.type == "cpu" and t.is_contiguous() and t.dtype == dtype, \
        (t.device, t.is_contiguous(), t.dtype, dtype)
    return t.data_ptr()


def _same_size(n: int, *ts) -> None:
    for t in ts:
        assert t.numel() == n, (t.numel(), n)


def _grad_operand(grads: torch.Tensor):
    """(pointer, is_bf16, keep-alive) of a grad tensor: bf16 as its bits,
    f32 as is, anything else converted to f32."""
    g = grads.reshape(-1)
    if g.dtype == torch.bfloat16:
        g = g.contiguous()
        return _ptr(g, torch.bfloat16), 1, g
    if g.dtype != torch.float32:            # e.g. an fp16 engine's grads
        g = g.float()
    g = g.contiguous()
    return _ptr(g), 0, g


def adam_step(params, grads, exp_avg, exp_avg_sq, step: int, lr: float,
              betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
              adamw_mode: bool = True, bias_correction: bool = True) -> None:
    """In-place Adam/AdamW on flat f32 host tensors. ``step`` is the 1-based
    count including this update."""
    n = params.numel()
    _same_size(n, grads, exp_avg, exp_avg_sq)
    load().dstpu_adam_step(_ptr(params), _ptr(grads), _ptr(exp_avg),
                           _ptr(exp_avg_sq), n, int(step), lr, betas[0],
                           betas[1], eps, weight_decay, int(adamw_mode),
                           int(bias_correction))


def adam_step_fused(params, grads, exp_avg, exp_avg_sq, step: int, lr: float,
                    betas=(0.9, 0.999), eps: float = 1e-8,
                    weight_decay: float = 0.0, adamw_mode: bool = True,
                    bias_correction: bool = True, grad_scale: float = 1.0,
                    emit_bf16: bool = False,
                    out: Optional[torch.Tensor] = None):
    """One sweep of the offload step: the grad (f32, or bf16 decoded inline)
    times ``grad_scale`` (the engine's clip factor), the moments and the
    master updated, and with ``emit_bf16`` the bf16 image written (into
    ``out`` when given). Returns the image or None."""
    n = params.numel()
    _same_size(n, grads, exp_avg, exp_avg_sq)
    g_ptr, g_bf16, _keep = _grad_operand(grads)
    img = None
    if emit_bf16:
        img = out if out is not None else torch.empty(n, dtype=torch.bfloat16)
        _same_size(n, img)
    load().dstpu_adam_step_fused(
        _ptr(params), g_ptr, g_bf16, grad_scale, _ptr(exp_avg),
        _ptr(exp_avg_sq), _ptr(img, torch.bfloat16) if img is not None else None,
        n, int(step), lr, betas[0], betas[1], eps, weight_decay,
        int(adamw_mode), int(bias_correction))
    return img


def adagrad_step(params, grads, sum_sq, lr: float, eps: float = 1e-10,
                 weight_decay: float = 0.0) -> None:
    n = params.numel()
    _same_size(n, grads, sum_sq)
    load().dstpu_adagrad_step(_ptr(params), _ptr(grads), _ptr(sum_sq), n, lr,
                              eps, weight_decay)


def copy_f32_to_bf16(src: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bf16 image of an f32 host tensor (round to nearest even)."""
    out = out if out is not None else torch.empty(src.shape, dtype=torch.bfloat16)
    _same_size(src.numel(), out)
    load().dstpu_copy_f32_to_bf16(_ptr(src), _ptr(out, torch.bfloat16),
                                  src.numel())
    return out


# --------------------------------------------------------- plain versions
def _f32(x: float) -> np.float32:
    return np.float32(x)


def adam_step_fused_plain(params, grads, exp_avg, exp_avg_sq, step: int,
                          lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                          weight_decay: float = 0.0, adamw_mode: bool = True,
                          bias_correction: bool = True, grad_scale: float = 1.0,
                          emit_bf16: bool = False, out=None):
    """The fused kernel's operations, in its order, in f32 torch ops."""
    b1, b2, wd = _f32(betas[0]), _f32(betas[1]), _f32(weight_decay)
    bc1 = bc2 = _f32(1.0)
    if bias_correction:
        bc1 = _f32(1.0) - b1 ** _f32(step)
        bc2 = _f32(1.0) - b2 ** _f32(step)
    inv_bc1, inv_bc2 = _f32(1.0) / bc1, _f32(1.0) / bc2
    g = grads.reshape(-1).float() * float(_f32(grad_scale))
    p = params.view(-1)
    if wd > 0 and not adamw_mode:
        g = g + float(wd) * p
    m = float(b1) * exp_avg.view(-1) + float(_f32(1.0) - b1) * g
    v = float(b2) * exp_avg_sq.view(-1) + float(_f32(1.0) - b2) * g * g
    exp_avg.view(-1).copy_(m)
    exp_avg_sq.view(-1).copy_(v)
    update = (m * float(inv_bc1)) / (torch.sqrt(v * float(inv_bc2)) + float(_f32(eps)))
    if wd > 0 and adamw_mode:
        update = update + float(wd) * p
    p.copy_(p - float(_f32(lr)) * update)
    if not emit_bf16:
        return None
    img = p.to(torch.bfloat16)
    if out is not None:
        out.view(-1).copy_(img)
        return out
    return img


def adam_step_plain(params, grads, exp_avg, exp_avg_sq, step: int, lr: float,
                    **kw) -> None:
    adam_step_fused_plain(params, grads, exp_avg, exp_avg_sq, step, lr, **kw)


def adagrad_step_plain(params, grads, sum_sq, lr: float, eps: float = 1e-10,
                       weight_decay: float = 0.0) -> None:
    g = grads.reshape(-1).float()
    p = params.view(-1)
    if weight_decay > 0:
        g = g + float(_f32(weight_decay)) * p
    s = sum_sq.view(-1) + g * g
    sum_sq.view(-1).copy_(s)
    p.copy_(p - float(_f32(lr)) * g / (torch.sqrt(s) + float(_f32(eps))))


def copy_f32_to_bf16_plain(src: torch.Tensor) -> torch.Tensor:
    return src.to(torch.bfloat16)
