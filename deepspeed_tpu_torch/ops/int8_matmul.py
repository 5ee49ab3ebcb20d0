"""Int8 weight-streaming matmul for memory-bound decode (port of
deepspeed_tpu/ops/int8_matmul.py ``int8_matmul_dma`` and ``int8_matmul``).

``(x [N, D]) @ (q [D, E] int8) * (s [E] f32) -> [N, E]`` in x's dtype, with
``q`` optionally the whole layer-stacked ``[L, D, E]`` tensor plus a layer
index. On a CUDA tensor it launches the hand-written kernel in
``csrc/int8_matmul.cu`` (the replacement of the TPU kernel
``ops/int8_matmul.py:_dma_kernel``; the source note says what bounds it and
how its design answers that): for bf16/fp16 x one launch on the tensor
cores, split along D into :func:`plan`'s slabs whose blocks sum in a
thread-block cluster; for f32 x the CUDA-core kernel, split into
:func:`k_splits` blocks along D with f32 partials summed by a second
launch. On a CPU tensor it runs :func:`int8_matmul_plain`, the same
function in plain PyTorch. There is no other path: a CUDA call the kernel
cannot take raises.

:func:`int8_matmul` is the gridded form of the same function (replaces the
TPU kernel ``ops/int8_matmul.py:_kernel``): one block per column tile walks
the whole of D, with no split and no partials. For bf16/fp16 x it runs
kernel 2's tensor-core body over :func:`grid_plan`'s column tiles (32 or 64
columns, narrow enough to fill the SMs); f32 x stays on the CUDA cores. It
is unrouted, as in the reference: ``models/base.qdot`` calls
:func:`int8_matmul_dma`.
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
    """Blocks along D of the f32 kernel: it gives every block 128 weight
    rows. A function of the shape only, so a row's result never depends on
    the batch or the card."""
    return -(-d // 128)


TILE_COLS = 128      # csrc/int8_matmul.cu tc::kCols: columns per block
STAGE_ROWS = 128     # tc::kStageRows: weight rows per ring stage
MAX_SPLITS = 8       # tc::kMaxSplits: a portable thread-block cluster
WAVE_SMS = 132       # the H100's SMs: the plan fills whole waves of them


def plan(d: int, e: int):
    """``(splits, slab)`` of the 16-bit kernel: D is cut into ``splits``
    slabs of ``slab`` rows (whole 128-row stages, every slab non-empty), one
    block per (slab, 128-column tile), the slabs of a tile forming one
    thread-block cluster. Picks the split count (1..8) whose blocks fill
    whole waves of 132 SMs best, the fewest on a tie. A function of (D, E)
    only, so a row's result never depends on the batch, the card or the
    run."""
    tiles = -(-e // TILE_COLS)
    stages = -(-d // STAGE_ROWS)
    best = None
    for splits in range(1, MAX_SPLITS + 1):
        per = -(-stages // splits)
        if -(-stages // per) != splits:       # a slab would be empty
            continue
        blocks = tiles * splits
        fill = blocks / (-(-blocks // WAVE_SMS) * WAVE_SMS)
        if best is None or fill > best[0] + 1e-9:
            best = (fill, splits, per * STAGE_ROWS)
    return best[1], best[2]


GRID_COLS = (32, 64)  # the gridded form's column tiles (int8_matmul_grid.cu)
WIDE_BLOCKS = 80      # the fewest 64-column blocks at which 64 beats 32


def grid_plan(d: int, e: int):
    """``(cols, big)`` of the gridded form for bf16/fp16 x: one block per
    ``cols``-column tile walks the whole of D (no split), so the tile width
    alone sets the block count. 64 columns where that gives at least
    :data:`WIDE_BLOCKS` blocks (0.6 of the 132 SMs), else 32: on an H100
    the 64-column tile took 0.72-0.90 of the 32-column tile's time at
    every decode matmul of LLaMA-7B, CodeLlama-34B and GPT-2 774M where it
    has 80 or more blocks, and 0.89-1.55 where it has fewer (PERF.md).
    ``big`` when the blocks fit one wave, so each
    takes a ring of up to 200 KB (one block an SM) where more blocks share
    an SM's 96 KB rings. A function of (D, E) only, so a row's result
    never depends on the batch, the card or the run."""
    cols = 64 if -(-e // 64) >= WIDE_BLOCKS else 32
    return cols, -(-e // cols) <= WAVE_SMS


def _check(what: str, x, q, s, nl: int):
    """Validate CUDA operands (q ``[D, E]`` or ``[nl, D, E]``, ``nl * E``
    scales); returns ``(n, d, e)``."""
    d2, e = q.shape[-2], q.shape[-1]
    if x.ndim != 2 or x.shape[1] != d2:
        raise ValueError(f"{what}: x {tuple(x.shape)} vs q {tuple(q.shape)}")
    n, d = x.shape
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"{what} takes 1..{MAX_ROWS} rows, got {n}")
    if e % 16:
        raise ValueError(f"{what} needs E % 16 == 0, got {e}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"{what}: q {q.dtype} (int8), s {s.dtype} (float32)")
    if s.shape[-1] != e or s.numel() != nl * e:
        raise ValueError(f"scales {tuple(s.shape)} do not match q {tuple(q.shape)}")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    return n, d, e


def _x_rows(x: torch.Tensor):
    """``(x, ldx)``: 16-bit x's rows feed a tensor map in 16-byte strides,
    so a D that is not a multiple of 8 is copied into rows of ``ldx``
    elements (the columns past D lie outside the map and read as zeros);
    f32 x is passed as it is."""
    d = x.shape[1]
    if x.dtype == torch.float32 or d % 8 == 0:
        return x, d
    return torch.nn.functional.pad(x, (0, -d % 8)), d + -d % 8


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
    if q.ndim not in (2, 3):
        raise ValueError(f"int8_matmul_dma: x {tuple(x.shape)}, q {tuple(q.shape)}")
    if not 0 <= layer < nl:
        raise ValueError(f"layer {layer} outside [0, {nl})")
    out = _launch_dma(x, q, s, layer)
    int8_matmul_dma.launches += 1
    return out


int8_matmul_dma.launches = 0


def _launch_dma(x, q, s, layer: int) -> torch.Tensor:
    """Checks the operands and launches kernel 2 (``layer`` an int, 0 for
    a ``[D, E]`` weight)."""
    nl = q.shape[0] if q.ndim == 3 else 1
    n, d, e = _check("int8_matmul_dma", x, q, s, nl)
    code = cuda_build.dtype_code(x.dtype)
    lib = cuda_build.kernels()
    out = torch.empty((n, e), dtype=x.dtype, device=x.device)
    x, ldx = _x_rows(x)
    part = None
    if x.dtype == torch.float32:
        splits, slab = k_splits(d), 128
        part = torch.empty((splits, n, e), dtype=torch.float32,
                           device=x.device)
    else:
        splits, slab = plan(d, e)
    err = lib.dst_int8_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), n, d, ldx, e, layer, nl,
        splits, slab, code, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "int8_matmul_dma")
    return out


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The gridded form: ``(x [N, D]) @ (q [D, E] int8) * (s [..., E] f32)
    -> [N, E]`` in x's dtype. ``s`` may carry leading unit dims (``[1, E]``),
    as in the reference. :func:`int8_matmul_plain` is its plain version."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if q.ndim != 2:
        raise ValueError(f"int8_matmul: q {tuple(q.shape)} is not [D, E]")
    out = _launch_grid(x, q, s)
    int8_matmul.launches += 1
    return out


def _launch_grid(x, q, s) -> torch.Tensor:
    """Checks the operands and launches the gridded kernel (16-bit x over
    :func:`grid_plan`'s column tiles)."""
    n, d, e = _check("int8_matmul", x, q, s, 1)
    lib = cuda_build.kernels()
    out = torch.empty((n, e), dtype=x.dtype, device=x.device)
    cols, big = grid_plan(d, e)
    x, ldx = _x_rows(x)
    err = lib.dst_int8_matmul_grid(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), n, d, ldx, e,
        cols, int(big), cuda_build.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "int8_matmul")
    return out


int8_matmul.launches = 0
