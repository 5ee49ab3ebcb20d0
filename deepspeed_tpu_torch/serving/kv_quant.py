"""Quantized KV-cache block storage (port of deepspeed_tpu/serving/kv_quant.py).

A quantized pool is the dict ``{"q": payload, "s": scales}`` in place of one
tensor, as in the JAX package:

  * ``payload`` has the unquantized pool's shape ``[L, N+1, Hkv, bs, Dh]`` in
    the storage dtype (int8 or float8_e4m3fn): the same garbage row, the
    same block-table addressing;
  * ``scales`` is ``[L, N+1, Hkv, bs]`` bf16, one symmetric scale per
    (layer, block, head, token), in token order. The JAX package keeps them
    pair-grouped ``[.., pair, bs/pair]`` to suit the TPU's lane tiling
    (its ``scales_token_order`` maps that form to this one); the port keeps
    the logical unpacked layout.

The scale is per token and head, so a token's scale is computed from its own
K/V row at store time and never revised. It is rounded to bf16 before the
divide, so quantize and dequantize use the identical scale. The same math
runs in the block decode kernel (csrc/block_decode_step.cu), which stores
bit-identical payloads and scales.

Casts: torch's ``float8_e4m3fn`` cast saturates at +-448 where the JAX
(ml_dtypes) cast gives NaN from 464 up. The quantizer never gets there: the
bf16-rounded scale bounds ``|x / s|`` at 448 * (1 + 2^-8), and every value
below 464 rounds to the same byte in both.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.serving.errors import EngineConfigError

# storage dtype + symmetric quantization ceiling per kv_dtype name
_KV_DTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}

SCALE_DTYPE = torch.bfloat16

# floor on the stored scale: a zero K/V row dequantizes to zero without a
# 0/0 in the quantize divide (the CUDA kernel uses the same constant)
SCALE_FLOOR = 1e-8


def normalize_kv_dtype(kv_dtype) -> Optional[str]:
    """Canonical kv_dtype name: ``None`` means unquantized (the pool stays
    in the engine's compute dtype)."""
    if kv_dtype in (None, "bf16", "bfloat16", "fp32", "float32"):
        return None
    if kv_dtype == "int8":
        return "int8"
    if kv_dtype in ("fp8", "float8", "float8_e4m3", "float8_e4m3fn"):
        return "fp8"
    raise EngineConfigError(
        f"kv_dtype must be one of None/'bf16'/'int8'/'fp8', got {kv_dtype!r}")


def storage_dtype(kv_dtype: str) -> torch.dtype:
    return _KV_DTYPES[kv_dtype][0]


def kv_qmax(kv_dtype: str) -> float:
    return _KV_DTYPES[kv_dtype][1]


def kv_dtype_of(payload: torch.Tensor) -> str:
    """The kv_dtype name of a quantized payload tensor."""
    return "int8" if payload.dtype == torch.int8 else "fp8"


def is_quantized_pool(pool) -> bool:
    """True for the ``{"q", "s"}`` dict form (tensor pools are unquantized)."""
    return isinstance(pool, dict) and "q" in pool


def pool_payload(pool) -> torch.Tensor:
    """The payload tensor of either pool form."""
    return pool["q"] if is_quantized_pool(pool) else pool


def kv_quantize_keepdims(x: torch.Tensor, kv_dtype: str
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization of ``x [..., Dh]`` ->
    ``(payload [..., Dh] storage dtype, scale [..., 1] bf16)``: amax over Dh
    in f32, ``s = bf16(max(amax / qmax, 1e-8))``, ``y = x / f32(s)``; int8
    rounds half to even and clips to +-127, fp8 casts (round to nearest
    even)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor: a python-scalar divisor may become a multiply by
    # its reciprocal on CUDA, one f32 ulp off the IEEE quotient
    qmax = torch.full_like(amax, kv_qmax(kv_dtype))
    s = torch.clamp_min(amax / qmax, SCALE_FLOOR).to(SCALE_DTYPE)
    y = x32 / s.float()
    if kv_dtype == "int8":
        payload = torch.round(y).clamp(-127.0, 127.0).to(torch.int8)
    else:
        payload = y.to(torch.float8_e4m3fn)
    return payload, s


def kv_quantize(x: torch.Tensor, kv_dtype: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`kv_quantize_keepdims` with the scale's unit dim squeezed."""
    payload, s = kv_quantize_keepdims(x, kv_dtype)
    return payload, s[..., 0]


def kv_dequantize(payload: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """``payload [..., Dh] * scale [...]`` -> ``[..., Dh]`` in ``dtype``: the
    product in f32 (exact for an 8-bit payload times a bf16 scale), cast
    once."""
    return (payload.float() * scale.float()[..., None]).to(dtype)


def quantized_pool_like(base_pool: torch.Tensor, kv_dtype: str, device=None):
    """The ``{"q", "s"}`` pool matching an unquantized pool's shape, on
    ``device`` (default: the base pool's). Scales start at zero, so
    never-written rows dequantize to 0."""
    l, n, hkv, bs, _ = base_pool.shape
    dev = base_pool.device if device is None else device
    return {"q": torch.zeros(base_pool.shape, dtype=storage_dtype(kv_dtype),
                             device=dev),
            "s": torch.zeros((l, n, hkv, bs), dtype=SCALE_DTYPE, device=dev)}


def tree_nbytes(tree) -> int:
    """Bytes of a pool (tensor or ``{"q", "s"}`` dict)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return int(tree.numel() * tree.element_size())
