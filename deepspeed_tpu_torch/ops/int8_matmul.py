"""Int8 weight-streaming matmul for memory-bound decode (port of
deepspeed_tpu/ops/int8_matmul.py ``int8_matmul_dma``).

``(x [N, D]) @ (q [D, E] int8) * (s [E] f32) -> [N, E]`` in x's dtype, with
``q`` optionally the whole layer-stacked ``[L, D, E]`` tensor plus a layer
index. On a CUDA tensor it launches the hand-written kernel in
``csrc/int8_matmul.cu`` (the replacement of the TPU kernel
``ops/int8_matmul.py:_dma_kernel``; the source note says what bounds it and
how its design answers that). On a CPU tensor it runs
:func:`int8_matmul_plain`, the same function in plain PyTorch. There is no
other path: a CUDA call the kernel cannot take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops import cuda_build

MAX_ROWS = 32   # decode-width activations only (models/base.qdot routes)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      layer: Optional[int] = None) -> torch.Tensor:
    """Plain version: ``(x.float() @ q.float()) * s`` in f32, cast once."""
    if q.ndim == 3:
        q, s = q[layer], s[layer]
    return ((x.float() @ q.float()) * s.reshape(-1).float()).to(x.dtype)


def k_splits(d: int) -> int:
    """Blocks along D: the kernel gives every block 128 weight rows. A
    function of the shape only, so a row's result never depends on the
    batch or the card."""
    return -(-d // 128)


def int8_matmul_dma(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                    layer: Optional[int] = None) -> torch.Tensor:
    """``x [N, D] @ q * s -> [N, E]``. ``q`` is ``[D, E]`` (``s`` ``[E]`` or
    ``[1, E]``) or the stacked ``[L, D, E]`` weight with ``layer`` an int
    (``s`` ``[L, 1, E]``); the kernel offsets into the stacked tensor, so no
    slice is copied."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, s, layer)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul_dma: unsupported device {x.device}")
    stacked = q.ndim == 3
    if stacked and layer is None:
        raise ValueError("stacked int8_matmul_dma needs layer")
    nl = q.shape[0] if stacked else 1
    layer = int(layer) if stacked else 0
    if x.ndim != 2 or q.ndim not in (2, 3):
        raise ValueError(f"int8_matmul_dma: x {tuple(x.shape)}, q {tuple(q.shape)}")
    n, d = x.shape
    d2, e = q.shape[-2], q.shape[-1]
    if d != d2:
        raise ValueError(f"int8_matmul_dma: x {tuple(x.shape)} vs q {tuple(q.shape)}")
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"int8_matmul_dma takes 1..{MAX_ROWS} rows, got {n}")
    if e % 16:
        raise ValueError(f"int8_matmul_dma needs E % 16 == 0, got {e}")
    if not 0 <= layer < nl:
        raise ValueError(f"layer {layer} outside [0, {nl})")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int8_matmul_dma: q {q.dtype} (int8), s {s.dtype} (float32)")
    if s.numel() != nl * e:
        raise ValueError(f"scales {tuple(s.shape)} do not match q {tuple(q.shape)}")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"int8_matmul_dma: {name} must be contiguous on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"int8_matmul_dma: {name} is not 16-byte aligned")
    code = cuda_build.dtype_code(x.dtype)
    lib = cuda_build.kernels()
    ks = k_splits(d)
    out = torch.empty((n, e), dtype=x.dtype, device=x.device)
    part = torch.empty((ks, n, e), dtype=torch.float32, device=x.device)
    err = lib.dst_int8_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        part.data_ptr(), n, d, e, layer, ks, code,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "int8_matmul_dma")
    int8_matmul_dma.launches += 1
    return out


int8_matmul_dma.launches = 0
