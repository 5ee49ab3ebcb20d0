"""FlashAttention-2 forward and backward (port of
deepspeed_tpu/ops/flash_attention.py).

Three hand-written CUDA kernels in ``csrc/flash_attention.cu``, one wrapper
each, with a launch counter:

* :func:`flash_fwd_parts` (kernel D, replaces ``_fwd_kernel``): flat
  ``[BH, Tq, Dh]`` q against ``[BH, Tk, Dh]`` k/v → ``(out, lse)``, lse f32
  ``[BH, Tq, 1]``.
* :func:`flash_bwd_dq` (kernel E, replaces ``_bwd_dq_kernel``) and
  :func:`flash_bwd_dkv` (kernel F, replaces ``_bwd_dkv_kernel``), composed by
  :func:`flash_bwd_parts` → ``(dq, dk, dv)`` from the GLOBAL ``lse`` and
  ``delta = rowsum(dO * O)`` (so per-hop grads of a sequence-parallel caller
  sum to the global gradient). ``delta`` stays plain torch, as it is jnp
  outside any kernel in the reference.
* :func:`flash_attention` on ``[B, T, H, Dh]``: a ``torch.autograd.Function``
  that saves only q, k, v, o and lse and runs the two backward kernels.

Contracts of the reference, kept by the kernels and the plain versions
beside them: products take storage-dtype operands and accumulate in f32;
``p`` and ``dS`` are rounded to the storage dtype before the second-stage
products; causal masking is top-left aligned (query row i sees key columns
``<= i``); masked scores are ``-1e30`` (an all-masked row gives exp → 0).
``DSTPU_FLASH_F32_PRECISE=1`` keeps ``p``/``dS`` in f32 in the plain
versions, as in the reference; the CUDA kernels do not implement it yet and
their wrappers raise when it is set.

CUDA tensors launch the kernels (bf16, fp16 and f32; Dh 64 or 128; any T,
causal or not) or raise ``ValueError`` on anything else. CPU tensors run
the plain versions.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import cuda_build

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def _f32_precise() -> bool:
    return os.environ.get("DSTPU_FLASH_F32_PRECISE") == "1"


def _mm_dtype(storage_dtype):
    """dtype of the computed p/dS operands of the second-stage products: the
    storage dtype unless ``DSTPU_FLASH_F32_PRECISE=1``."""
    return torch.float32 if _f32_precise() else storage_dtype


# ------------------------------------------------------------ plain versions
def _scores(qf, kf, causal: bool, sc: float):
    """f32 ``q . k^T * scale`` from storage-dtype operands, top-left causal
    mask at -1e30."""
    s = torch.matmul(qf.float(), kf.float().transpose(1, 2)) * sc
    if causal:
        tq, tk = qf.shape[1], kf.shape[1]
        keep = torch.ones((tq, tk), dtype=torch.bool, device=qf.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def _round(x, dtype):
    return x.to(_mm_dtype(dtype)).float()


def flash_fwd_parts_plain(qf, kf, vf, *, causal: bool,
                          scale: Optional[float] = None):
    """Plain version of :func:`flash_fwd_parts` (the whole key range as one
    tile)."""
    sc = float(scale) if scale is not None else qf.shape[-1] ** -0.5
    s = _scores(qf, kf, causal, sc)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-20)
    acc = torch.matmul(_round(p, vf.dtype), vf.float())
    return (acc / l_safe).to(qf.dtype), m + torch.log(l_safe)


def _bwd_p_ds(qf, kf, vf, dof, lse, delta, causal: bool, sc: float):
    p = torch.exp(_scores(qf, kf, causal, sc) - lse)
    dp = torch.matmul(dof.float(), vf.float().transpose(1, 2))
    return p, p * (dp - delta)


def flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, *, causal: bool,
                       scale: Optional[float] = None):
    sc = float(scale) if scale is not None else qf.shape[-1] ** -0.5
    _, ds = _bwd_p_ds(qf, kf, vf, dof, lse, delta, causal, sc)
    return (torch.matmul(_round(ds, kf.dtype), kf.float()) * sc).to(qf.dtype)


def flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, *, causal: bool,
                        scale: Optional[float] = None):
    sc = float(scale) if scale is not None else qf.shape[-1] ** -0.5
    p, ds = _bwd_p_ds(qf, kf, vf, dof, lse, delta, causal, sc)
    dv = torch.matmul(_round(p, dof.dtype).transpose(1, 2), dof.float())
    dk = torch.matmul(_round(ds, qf.dtype).transpose(1, 2), qf.float()) * sc
    return dk.to(kf.dtype), dv.to(vf.dtype)


# ---------------------------------------------------------------- wrappers
def _check(what: str, qf, kf, vf, extra=()):
    """Validate flat CUDA operands; returns ``(bh, tq, tk, dh)``."""
    if _f32_precise():
        raise ValueError(f"{what}: DSTPU_FLASH_F32_PRECISE=1 (f32 p/dS "
                         "operands) is not implemented by the CUDA kernels")
    if qf.ndim != 3 or kf.ndim != 3 or vf.shape != kf.shape:
        raise ValueError(f"{what}: q {tuple(qf.shape)}, k {tuple(kf.shape)}, "
                         f"v {tuple(vf.shape)} are not flat [BH, T, Dh] "
                         "operands with matching k/v")
    bh, tq, dh = qf.shape
    tk = kf.shape[1]
    if kf.shape[0] != bh or kf.shape[2] != dh:
        raise ValueError(f"{what}: k {tuple(kf.shape)} vs q {tuple(qf.shape)}")
    if (dh not in _HEAD_DIMS or qf.dtype not in _DTYPES or not 0 < bh <= 65535
            or tq < 1 or tk < 1):
        raise ValueError(f"{what}: unsupported geometry BH={bh} Tq={tq} "
                         f"Tk={tk} Dh={dh} {qf.dtype} (Dh in {_HEAD_DIMS}, "
                         "f32/f16/bf16)")
    for name, t in (("q", qf), ("k", kf), ("v", vf)) + tuple(extra):
        want = torch.float32 if name in ("lse", "delta") else qf.dtype
        if t.device != qf.device or t.dtype != want:
            raise ValueError(f"{what}: {name} must be {want} on {qf.device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             "aligned")
    return bh, tq, tk, dh


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd_parts(qf, kf, vf, *, causal: bool, scale: Optional[float] = None):
    """Kernel-level forward on flat operands: q ``[BH, Tq, Dh]``, k/v ``[BH,
    Tk, Dh]`` → ``(out [BH, Tq, Dh], lse f32 [BH, Tq, 1])``."""
    if qf.device.type == "cpu":
        return flash_fwd_parts_plain(qf, kf, vf, causal=causal, scale=scale)
    if qf.device.type != "cuda":
        raise ValueError(f"flash_fwd_parts: unsupported device {qf.device}")
    bh, tq, tk, dh = _check("flash_fwd_parts", qf, kf, vf)
    sc = float(scale) if scale is not None else dh ** -0.5
    lib = cuda_build.kernels()
    out = torch.empty_like(qf)
    lse = torch.empty((bh, tq, 1), dtype=torch.float32, device=qf.device)
    err = lib.dst_flash_fwd(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), bh, tq, tk, dh,
                            int(bool(causal)), sc,
                            cuda_build.dtype_code(qf.dtype), _stream(qf))
    cuda_build.check(lib, err, "flash_fwd_parts")
    flash_fwd_parts.launches += 1
    return out, lse


flash_fwd_parts.launches = 0


def _bwd_check(what, qf, kf, vf, dof, lse, delta):
    bh, tq, tk, dh = _check(what, qf, kf, vf, (("dout", dof), ("lse", lse),
                                               ("delta", delta)))
    if dof.shape != qf.shape or lse.shape != (bh, tq, 1) \
            or delta.shape != (bh, tq, 1):
        raise ValueError(f"{what}: dout {tuple(dof.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} vs "
                         f"q {tuple(qf.shape)}")
    return bh, tq, tk, dh


def flash_bwd_dq(qf, kf, vf, dof, lse, delta, *, causal: bool,
                 scale: Optional[float] = None):
    """Backward dQ ``[BH, Tq, Dh]`` (kernel E)."""
    if qf.device.type == "cpu":
        return flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, causal=causal,
                                  scale=scale)
    if qf.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {qf.device}")
    bh, tq, tk, dh = _bwd_check("flash_bwd_dq", qf, kf, vf, dof, lse, delta)
    sc = float(scale) if scale is not None else dh ** -0.5
    lib = cuda_build.kernels()
    dq = torch.empty_like(qf)
    err = lib.dst_flash_bwd_dq(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                               dof.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                               dq.data_ptr(), bh, tq, tk, dh, int(bool(causal)),
                               sc, cuda_build.dtype_code(qf.dtype), _stream(qf))
    cuda_build.check(lib, err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(qf, kf, vf, dof, lse, delta, *, causal: bool,
                  scale: Optional[float] = None):
    """Backward ``(dK, dV)``, each ``[BH, Tk, Dh]`` (kernel F)."""
    if qf.device.type == "cpu":
        return flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, causal=causal,
                                   scale=scale)
    if qf.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {qf.device}")
    bh, tq, tk, dh = _bwd_check("flash_bwd_dkv", qf, kf, vf, dof, lse, delta)
    sc = float(scale) if scale is not None else dh ** -0.5
    lib = cuda_build.kernels()
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    err = lib.dst_flash_bwd_dkv(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                                dof.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                bh, tq, tk, dh, int(bool(causal)), sc,
                                cuda_build.dtype_code(qf.dtype), _stream(qf))
    cuda_build.check(lib, err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_parts(qf, kf, vf, dof, lse, delta, *, causal: bool,
                    scale: Optional[float] = None):
    """Kernel-level backward on flat operands → ``(dq, dk, dv)``; ``lse`` and
    ``delta`` (f32 ``[BH, Tq, 1]``) are the GLOBAL log-sum-exp rows and
    ``rowsum(dO * O)``."""
    dq = flash_bwd_dq(qf, kf, vf, dof, lse, delta, causal=causal, scale=scale)
    dk, dv = flash_bwd_dkv(qf, kf, vf, dof, lse, delta, causal=causal,
                           scale=scale)
    return dq, dk, dv


# ------------------------------------------------------- [B, T, H, Dh] op
def _reshape_bh(x):
    b, t, h, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, dh).contiguous()


def _unshape_bh(x, b: int, h: int):
    bh, t, dh = x.shape
    return x.reshape(b, h, t, dh).permute(0, 2, 1, 3)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        b, _, h, _ = q.shape
        qf, kf, vf = _reshape_bh(q), _reshape_bh(k), _reshape_bh(v)
        out, lse = flash_fwd_parts(qf, kf, vf, causal=causal, scale=scale)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.causal, ctx.scale, ctx.bh = causal, scale, (b, h)
        return _unshape_bh(out, b, h)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse = ctx.saved_tensors
        b, h = ctx.bh
        dof = _reshape_bh(g)
        delta = (dof.float() * out.float()).sum(-1, keepdim=True)
        dq, dk, dv = flash_bwd_parts(qf, kf, vf, dof, lse, delta,
                                     causal=ctx.causal, scale=ctx.scale)
        return (_unshape_bh(dq, b, h), _unshape_bh(dk, b, h),
                _unshape_bh(dv, b, h), None, None)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """q/k/v ``[B, T, H, Dh]`` → ``[B, T, H, Dh]`` (MHA: the same head count),
    differentiable through the backward kernels."""
    return _FlashAttention.apply(q, k, v, causal, scale)
