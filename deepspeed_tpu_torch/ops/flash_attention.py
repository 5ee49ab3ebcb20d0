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
``DSTPU_FLASH_F32_PRECISE=1`` (read per call, as the reference reads it)
keeps ``p``/``dS`` in f32 for the second-stage products. The plain versions
honour it, and on a CUDA tensor the three wrappers then launch the
f32-precise kernels of ``csrc/flash_precise.cu`` instead, each with a
wrapper and launch counter of its own (:func:`flash_fwd_precise`,
:func:`flash_bwd_dq_precise`, :func:`flash_bwd_dkv_precise`): every operand
converted to f32 and every product an f32 FMA on the CUDA cores.

CUDA tensors launch the kernels (bf16, fp16 and f32; Dh 64 or 128; any T,
causal or not) or raise ``ValueError`` on anything else. CPU tensors run
the plain versions. Either way a wrapper reports its kernel's products to
the FLOPs profiler (ops/kernel_flops.py): 4, 6 and 8 x BH x Dh x the
(query, key) pairs visited for D, E and F.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import cuda_build, kernel_flops

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def _f32_precise() -> bool:
    return os.environ.get("DSTPU_FLASH_F32_PRECISE") == "1"


def _mm_dtype(storage_dtype, precise: Optional[bool] = None):
    """dtype of the computed p/dS operands of the second-stage products: the
    storage dtype unless ``precise`` (default: ``DSTPU_FLASH_F32_PRECISE=1``)."""
    if precise is None:
        precise = _f32_precise()
    return torch.float32 if precise else storage_dtype


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


def _round(x, dtype, precise: Optional[bool] = None):
    return x.to(_mm_dtype(dtype, precise)).float()


def flash_fwd_parts_plain(qf, kf, vf, *, causal: bool,
                          scale: Optional[float] = None,
                          precise: Optional[bool] = None):
    """Plain version of :func:`flash_fwd_parts` (the whole key range as one
    tile); ``precise`` None reads ``DSTPU_FLASH_F32_PRECISE``."""
    sc = float(scale) if scale is not None else qf.shape[-1] ** -0.5
    s = _scores(qf, kf, causal, sc)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-20)
    acc = torch.matmul(_round(p, vf.dtype, precise), vf.float())
    return (acc / l_safe).to(qf.dtype), m + torch.log(l_safe)


def _bwd_p_ds(qf, kf, vf, dof, lse, delta, causal: bool, sc: float):
    p = torch.exp(_scores(qf, kf, causal, sc) - lse)
    dp = torch.matmul(dof.float(), vf.float().transpose(1, 2))
    return p, p * (dp - delta)


def flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, *, causal: bool,
                       scale: Optional[float] = None,
                       precise: Optional[bool] = None):
    sc = float(scale) if scale is not None else qf.shape[-1] ** -0.5
    _, ds = _bwd_p_ds(qf, kf, vf, dof, lse, delta, causal, sc)
    return (torch.matmul(_round(ds, kf.dtype, precise), kf.float())
            * sc).to(qf.dtype)


def flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, *, causal: bool,
                        scale: Optional[float] = None,
                        precise: Optional[bool] = None):
    sc = float(scale) if scale is not None else qf.shape[-1] ** -0.5
    p, ds = _bwd_p_ds(qf, kf, vf, dof, lse, delta, causal, sc)
    dv = torch.matmul(_round(p, dof.dtype, precise).transpose(1, 2),
                      dof.float())
    dk = torch.matmul(_round(ds, qf.dtype, precise).transpose(1, 2),
                      qf.float()) * sc
    return dk.to(kf.dtype), dv.to(vf.dtype)


# ---------------------------------------------------------------- wrappers
def _check(what: str, qf, kf, vf, extra=()):
    """Validate flat CUDA operands; returns ``(bh, tq, tk, dh)``."""
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


# products per (query, key) pair and head dim: D computes q.k^T and p.V; E
# recomputes S and dP and takes dS.K; F recomputes S and dP and takes
# P^T.dO and dS^T.Q
_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}


def _report(name: str, part: str, qf, kf, causal: bool) -> None:
    bh, tq, dh = qf.shape
    pairs = kernel_flops.attn_pairs(tq, kf.shape[1], causal)
    kernel_flops.report(name, 2 * _PRODUCTS[part] * bh * dh * pairs)


def flash_fwd_parts(qf, kf, vf, *, causal: bool, scale: Optional[float] = None):
    """Kernel-level forward on flat operands: q ``[BH, Tq, Dh]``, k/v ``[BH,
    Tk, Dh]`` → ``(out [BH, Tq, Dh], lse f32 [BH, Tq, 1])``."""
    if qf.device.type == "cpu":
        _report("flash_fwd_parts", "fwd", qf, kf, causal)
        return kernel_flops.plain(flash_fwd_parts_plain, qf, kf, vf,
                                  causal=causal, scale=scale)
    if qf.device.type != "cuda":
        raise ValueError(f"flash_fwd_parts: unsupported device {qf.device}")
    if _f32_precise():
        return flash_fwd_precise(qf, kf, vf, causal=causal, scale=scale)
    return _launch_fwd(flash_fwd_parts, "dst_flash_fwd", qf, kf, vf, causal,
                       scale)


flash_fwd_parts.launches = 0


def _launch_fwd(wrapper, fn: str, qf, kf, vf, causal, scale):
    bh, tq, tk, dh = _check(wrapper.__name__, qf, kf, vf)
    sc = float(scale) if scale is not None else dh ** -0.5
    lib = cuda_build.kernels()
    out = torch.empty_like(qf)
    lse = torch.empty((bh, tq, 1), dtype=torch.float32, device=qf.device)
    err = getattr(lib, fn)(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), bh, tq, tk, dh,
                           int(bool(causal)), sc,
                           cuda_build.dtype_code(qf.dtype), _stream(qf))
    cuda_build.check(lib, err, wrapper.__name__)
    wrapper.launches += 1
    _report(wrapper.__name__, "fwd", qf, kf, causal)
    return out, lse


def _launch_dq(wrapper, fn: str, qf, kf, vf, dof, lse, delta, causal, scale):
    bh, tq, tk, dh = _bwd_check(wrapper.__name__, qf, kf, vf, dof, lse, delta)
    sc = float(scale) if scale is not None else dh ** -0.5
    lib = cuda_build.kernels()
    dq = torch.empty_like(qf)
    err = getattr(lib, fn)(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                           dof.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dq.data_ptr(), bh, tq, tk, dh, int(bool(causal)),
                           sc, cuda_build.dtype_code(qf.dtype), _stream(qf))
    cuda_build.check(lib, err, wrapper.__name__)
    wrapper.launches += 1
    _report(wrapper.__name__, "dq", qf, kf, causal)
    return dq


def _launch_dkv(wrapper, fn: str, qf, kf, vf, dof, lse, delta, causal, scale):
    bh, tq, tk, dh = _bwd_check(wrapper.__name__, qf, kf, vf, dof, lse, delta)
    sc = float(scale) if scale is not None else dh ** -0.5
    lib = cuda_build.kernels()
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    err = getattr(lib, fn)(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                           dof.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), bh, tq, tk, dh,
                           int(bool(causal)), sc,
                           cuda_build.dtype_code(qf.dtype), _stream(qf))
    cuda_build.check(lib, err, wrapper.__name__)
    wrapper.launches += 1
    _report(wrapper.__name__, "dkv", qf, kf, causal)
    return dk, dv


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
        _report("flash_bwd_dq", "dq", qf, kf, causal)
        return kernel_flops.plain(flash_bwd_dq_plain, qf, kf, vf, dof, lse,
                                  delta, causal=causal, scale=scale)
    if qf.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {qf.device}")
    if _f32_precise():
        return flash_bwd_dq_precise(qf, kf, vf, dof, lse, delta,
                                    causal=causal, scale=scale)
    return _launch_dq(flash_bwd_dq, "dst_flash_bwd_dq", qf, kf, vf, dof, lse,
                      delta, causal, scale)


flash_bwd_dq.launches = 0


def flash_bwd_dkv(qf, kf, vf, dof, lse, delta, *, causal: bool,
                  scale: Optional[float] = None):
    """Backward ``(dK, dV)``, each ``[BH, Tk, Dh]`` (kernel F)."""
    if qf.device.type == "cpu":
        _report("flash_bwd_dkv", "dkv", qf, kf, causal)
        return kernel_flops.plain(flash_bwd_dkv_plain, qf, kf, vf, dof, lse,
                                  delta, causal=causal, scale=scale)
    if qf.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {qf.device}")
    if _f32_precise():
        return flash_bwd_dkv_precise(qf, kf, vf, dof, lse, delta,
                                     causal=causal, scale=scale)
    return _launch_dkv(flash_bwd_dkv, "dst_flash_bwd_dkv", qf, kf, vf, dof,
                       lse, delta, causal, scale)


flash_bwd_dkv.launches = 0


# ----------------------------------------------------- f32-precise kernels
# The reference's DSTPU_FLASH_F32_PRECISE=1 kernels (its _fwd_kernel,
# _bwd_dq_kernel and _bwd_dkv_kernel with f32 p / dS operands): the plain
# versions above under the flag are what they are held against.
def _on_cuda(what: str, qf) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    one; raises for any other device."""
    if qf.device.type == "cpu":
        return False
    if qf.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qf.device}")
    return True


def flash_fwd_precise(qf, kf, vf, *, causal: bool,
                      scale: Optional[float] = None):
    """Kernel D in f32-precise mode: :func:`flash_fwd_parts` with p kept in
    f32 for P.V (``csrc/flash_precise.cu``)."""
    if not _on_cuda("flash_fwd_precise", qf):
        _report("flash_fwd_precise", "fwd", qf, kf, causal)
        return kernel_flops.plain(flash_fwd_parts_plain, qf, kf, vf,
                                  causal=causal, scale=scale, precise=True)
    return _launch_fwd(flash_fwd_precise, "dst_flash_fwd_precise", qf, kf, vf,
                       causal, scale)


flash_fwd_precise.launches = 0


def flash_bwd_dq_precise(qf, kf, vf, dof, lse, delta, *, causal: bool,
                         scale: Optional[float] = None):
    """Kernel E in f32-precise mode: dS kept in f32 for dS.K."""
    if not _on_cuda("flash_bwd_dq_precise", qf):
        _report("flash_bwd_dq_precise", "dq", qf, kf, causal)
        return kernel_flops.plain(flash_bwd_dq_plain, qf, kf, vf, dof, lse,
                                  delta, causal=causal, scale=scale,
                                  precise=True)
    return _launch_dq(flash_bwd_dq_precise, "dst_flash_bwd_dq_precise", qf, kf,
                      vf, dof, lse, delta, causal, scale)


flash_bwd_dq_precise.launches = 0


def flash_bwd_dkv_precise(qf, kf, vf, dof, lse, delta, *, causal: bool,
                          scale: Optional[float] = None):
    """Kernel F in f32-precise mode: p and dS kept in f32 for P^T.dO and
    dS^T.Q."""
    if not _on_cuda("flash_bwd_dkv_precise", qf):
        _report("flash_bwd_dkv_precise", "dkv", qf, kf, causal)
        return kernel_flops.plain(flash_bwd_dkv_plain, qf, kf, vf, dof, lse,
                                  delta, causal=causal, scale=scale,
                                  precise=True)
    return _launch_dkv(flash_bwd_dkv_precise, "dst_flash_bwd_dkv_precise", qf,
                       kf, vf, dof, lse, delta, causal, scale)


flash_bwd_dkv_precise.launches = 0


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
