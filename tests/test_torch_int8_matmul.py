"""Parity of the port's int8 weight-streaming matmul and int8 quantization
(deepspeed_tpu_torch/ops/int8_matmul, compression/quantize, models/base.qdot)
with the JAX package's.

On the CPU the port's ``int8_matmul_dma`` and its gridded form
``int8_matmul`` run their one plain version
(``(x.float() @ q.float()) * s`` cast once); the JAX side runs its Pallas
kernel in interpret mode. Inputs come from one numpy seed.

The CUDA paths' arguments (kernel 2's split plan, the gridded form's
column tile) are traced on meta tensors with the library replaced, and both
plans are pinned as functions of (D, E) over every routed LLaMA-7B,
CodeLlama-34B and GPT-2 774M shape.

Tolerances: ``quantize_int8`` must be bit-identical (same f32 scale,
division and round-half-to-even). The matmuls accumulate exact products in
f32 in different orders and cast once to bf16, so they agree to one bf16
ulp: |out - ref| <= 2^-7 * |ref| + 1e-3 (rtol 8e-3). ``qdot``'s einsum-dequant
path rounds the matmul to bf16 and then multiplies the bf16 scale, two
roundings: rtol 1.6e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.compression.quantize import quantize_int8 as jax_quantize_int8
from deepspeed_tpu.models.base import qdot as jax_qdot
from deepspeed_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from deepspeed_tpu.ops.int8_matmul import int8_matmul_dma as jax_int8_matmul_dma
from deepspeed_tpu_torch.compression.quantize import dequantize_int8, quantize_int8
from deepspeed_tpu_torch.models.base import layer_view, qdot
from deepspeed_tpu_torch.ops.int8_matmul import (GRID_COLS, WIDE_BLOCKS,
                                                 grid_plan, int8_matmul,
                                                 int8_matmul_dma, k_splits,
                                                 plan)


def _mk(n, d, e, l=None, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    qshape = (d, e) if l is None else (l, d, e)
    q = rng.randint(-128, 128, qshape).astype(np.int8)
    s = (np.abs(rng.randn(*((e,) if l is None else (l, 1, e)))) * 0.01
         ).astype(np.float32)
    return x, q, s


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _close(out, ref, rtol):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-3)


@pytest.mark.parametrize("n,d,e", [(1, 256, 512), (8, 384, 1408),
                                   (32, 256, 384)])
def test_int8_matmul_dma_matches_jax_kernel(n, d, e):
    x, q, s = _mk(n, d, e)
    ref = jax_int8_matmul_dma(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                              jnp.asarray(s), interpret=True)
    out = int8_matmul_dma(_bf16(x), torch.from_numpy(q), torch.from_numpy(s))
    assert out.dtype == torch.bfloat16 and out.shape == (n, e)
    _close(out, ref, rtol=8e-3)


@pytest.mark.parametrize("layer", [0, 2])
def test_int8_matmul_dma_stacked_layer_matches_jax_kernel(layer):
    x, q, s = _mk(4, 256, 640, l=3, seed=1)
    ref = jax_int8_matmul_dma(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                              jnp.asarray(s), jnp.int32(layer),
                              interpret=True)
    out = int8_matmul_dma(_bf16(x), torch.from_numpy(q), torch.from_numpy(s),
                          layer)
    _close(out, ref, rtol=8e-3)


# the reference test's shapes (tests/unit/ops/test_int8_matmul.py), the
# non-divisible (2, 384, 640) among them; scales carry a leading unit dim
@pytest.mark.parametrize("n,d,e", [(1, 256, 512), (8, 768, 2304),
                                   (2, 1024, 768), (2, 384, 640)])
def test_gridded_int8_matmul_matches_jax_kernel(n, d, e):
    x, q, s = _mk(n, d, e, seed=d)
    s = s.reshape(1, e)
    ref = jax_int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                          jnp.asarray(s), interpret=True)
    out = int8_matmul(_bf16(x), torch.from_numpy(q), torch.from_numpy(s))
    assert out.dtype == torch.bfloat16 and out.shape == (n, e)
    _close(out, ref, rtol=8e-3)


def test_qdot_einsum_path_matches_jax_qdot():
    """> 32 rows (prefill) and every CPU call take the einsum-dequant path
    in both packages; the stacked weight is indexed by layer."""
    x, q, s = _mk(40, 256, 384, l=2, seed=2)
    x3 = x.reshape(2, 20, 256)
    w = {"__q__": q, "__scale__": s}
    jw = jax.tree_util.tree_map(jnp.asarray, w)
    jw["__layer__"] = jnp.int32(1)
    ref = jax_qdot("btd,de->bte", jnp.asarray(x3, jnp.bfloat16), jw)
    tw = layer_view({"w": {k: torch.from_numpy(v) for k, v in w.items()}}, 1)
    out = qdot("btd,de->bte", _bf16(x3), tw["w"])
    _close(out, ref, rtol=1.6e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bit_identical(dtype):
    rng = np.random.RandomState(3)
    w = (rng.randn(3, 64, 96) * 0.02).astype(np.float32)
    w[1, :, 5] = 0.0                       # all-zero column: the 1e-10 floor
    jw = jnp.asarray(w, jnp.dtype(dtype))
    jq, js = jax.vmap(lambda a: jax_quantize_int8(a, per_channel_axis=1))(jw)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    tq, ts = quantize_int8(tw, reduce_dims=(1,))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the per_channel_axis form on one layer agrees with the stacked form
    q1, s1 = quantize_int8(tw[2], per_channel_axis=1)
    assert torch.equal(q1, tq[2]) and torch.equal(s1, ts[2])
    deq = dequantize_int8(tq, ts, torch.float32)
    assert (deq - tw.float()).abs().max() <= ts.max() / 2 + 1e-9


# every (D, E) that models/base.qdot routes to the kernel for LLaMA-7B
# (q/k/v/o, gate/up, down), CodeLlama-34B (q/o, k/v at 8 kv heads,
# gate/up, down) and GPT-2 774M (qkv, proj, fc, fc2)
ROUTED_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096),
                 (8192, 8192), (8192, 1024), (8192, 22016), (22016, 8192),
                 (1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280)]


@pytest.mark.parametrize("d,e", ROUTED_SHAPES)
def test_k_splits_depends_on_shape_only(d, e):
    """The 16-bit kernel's plan (splits of D into whole 128-row stages, one
    thread-block cluster per 128-column tile) from (D, E) alone: at most 8
    splits (a portable cluster), every split holding rows, the slabs
    covering D once, and no split count filling whole waves of 132 SMs
    better. The f32 kernel gives every block 128 weight rows."""
    splits, slab = plan(d, e)
    assert plan(d, e) == (splits, slab)
    assert 1 <= splits <= 8 and slab % 128 == 0
    assert (splits - 1) * slab < d <= splits * slab
    tiles = -(-e // 128)

    def fill(ks):
        blocks = tiles * ks
        return blocks / (-(-blocks // 132) * 132)

    stages = -(-d // 128)
    valid = [ks for ks in range(1, 9)
             if -(-stages // -(-stages // ks)) == ks]
    assert fill(splits) == max(fill(ks) for ks in valid)
    assert splits == min(ks for ks in valid if fill(ks) == fill(splits))
    assert k_splits(d) == -(-d // 128)
    if (d, e) == (4096, 4096):
        assert (splits, slab) == (4, 1024)        # 128 blocks
    if (d, e) == (4096, 11008):
        assert (splits, slab) == (3, 1408)        # 258 blocks
    if (d, e) == (11008, 4096):
        assert (splits, slab) == (4, 2816)        # 128 blocks
        assert k_splits(d) == 86


@pytest.mark.parametrize("d,e", ROUTED_SHAPES)
def test_grid_plan_depends_on_shape_only(d, e):
    """The gridded form's column tile from (D, E) alone: one of the
    kernel's widths (32 or 64 columns), its tiles covering E once in at
    most 65535 blocks, 64 exactly when that gives WIDE_BLOCKS blocks or
    more, and the big ring exactly when the blocks fit one wave."""
    cols, big = grid_plan(d, e)
    assert cols in GRID_COLS == (32, 64) and grid_plan(d, e) == (cols, big)
    blocks = -(-e // cols)
    assert (blocks - 1) * cols < e <= blocks * cols and blocks <= 65535
    assert big == (blocks <= 132)
    assert (cols == 64) == (-(-e // 64) >= WIDE_BLOCKS == 80)
    expect = {4096: (32, True), 11008: (64, False), 1024: (32, True),
              8192: (64, True), 22016: (64, False), 3840: (32, True),
              1280: (32, True), 5120: (64, True)}
    assert (cols, big) == expect[e]


def _ldx(dtype, d):
    """x's row stride as the wrappers pass it: D, rounded up to a multiple
    of 8 for 16-bit x."""
    return d if dtype == torch.float32 else -(-d // 8) * 8


class _FakeLib:
    """Stands in for the kernel library: records the arguments of
    dst_int8_matmul and dst_int8_matmul_grid and returns success."""

    def __init__(self):
        self.calls = []

    def dst_int8_matmul(self, *args):
        self.calls.append(args)
        return 0

    dst_int8_matmul_grid = dst_int8_matmul


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("n,d,e,layers", [(8, 4096, 4096, 3),
                                          (1, 4096, 11008, 2),
                                          (32, 11008, 4096, 1),
                                          (4, 1001, 656, 2)])
def test_wrapper_launches_with_its_plan(monkeypatch, dtype, n, d, e, layers):
    """The CUDA path's arguments, traced on meta tensors with the library
    replaced: 16-bit x launches under :func:`plan` with no partials, f32 x
    under :func:`k_splits` with [splits, N, E] f32 partials; the stacked
    weight goes through whole, with its layer count and the layer index;
    16-bit x's rows are whole multiples of 8 elements."""
    from deepspeed_tpu_torch.ops import cuda_build
    from deepspeed_tpu_torch.ops import int8_matmul as tmm

    lib = _FakeLib()
    monkeypatch.setattr(cuda_build, "kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    x = torch.empty((n, d), dtype=dtype, device="meta")
    q = torch.empty((layers, d, e), dtype=torch.int8, device="meta")
    s = torch.empty((layers, 1, e), dtype=torch.float32, device="meta")
    out = tmm._launch_dma(x, q, s, layers - 1)
    assert out.shape == (n, e) and out.dtype == dtype
    (args,) = lib.calls
    assert args[5:11] == (n, d, _ldx(dtype, d), e, layers - 1, layers)
    if dtype == torch.float32:
        assert args[11] == k_splits(d) and args[4] is not None
    else:
        assert tuple(args[11:13]) == plan(d, e) and args[4] is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("n,d,e", [(8, 4096, 4096), (1, 4096, 11008),
                                   (32, 8192, 22016), (4, 1001, 656)])
def test_gridded_wrapper_launches_with_its_plan(monkeypatch, dtype, n, d, e):
    """The gridded form's CUDA arguments, traced on meta tensors with the
    library replaced: ``grid_plan``'s column tile and ring, the shape, x's
    row stride (a multiple of 8 elements for 16-bit x) and the dtype."""
    from deepspeed_tpu_torch.ops import cuda_build
    from deepspeed_tpu_torch.ops import int8_matmul as tmm

    lib = _FakeLib()
    monkeypatch.setattr(cuda_build, "kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    x = torch.empty((n, d), dtype=dtype, device="meta")
    q = torch.empty((d, e), dtype=torch.int8, device="meta")
    s = torch.empty((1, e), dtype=torch.float32, device="meta")
    out = tmm._launch_grid(x, q, s)
    assert out.shape == (n, e) and out.dtype == dtype
    (args,) = lib.calls
    cols, big = grid_plan(d, e)
    assert args[4:11] == (n, d, _ldx(dtype, d), e, cols, int(big),
                          cuda_build.dtype_code(dtype))
