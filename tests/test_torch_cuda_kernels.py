"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (in its fixture) where no CUDA device is
present, as on a CPU-only machine. This file imports neither jax nor the
JAX package, so on a card machine without jax it runs with the repo's
conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Coverage beyond chip_smoke.py's full-width checks: every element type the
kernels take, ragged shapes (S not a multiple of the chunk, E not a
multiple of the column tile, odd N), the scalar and per-slot index forms,
the dropped write at idx == S, row independence (a slot's or a row's result
does not depend on its neighbours), and the wrappers' input checks. The
fused decode step's split along the cache: idx at and around the split
edges, S - 1 and S with 0 beside S - 1 in one launch, rep 1 to 32, Dh 40
(the CUDA-core body), 64 and 128, the cache past idx poisoned and unread,
run-to-run bit identity, one launch counted per call, and a call captured in
a CUDA graph replayed after the device idx changes. The
block decode step: bf16/f16/f32 compute over pools in the compute type,
int8 and fp8 (payload and scales), a permuted table, block edges, the
overflow write to the garbage row, an inactive slot on a sentinel table;
its split along the prefix: idx at the last and first positions of
splits, two overflow slots (their garbage rows bit-identical to the plain
version's), run-to-run bit identity, and a call captured in a CUDA graph
replayed after the device idx and table change.
The flash attention kernels (forward, backward dQ, backward dK/dV): bf16,
f16 and f32 at Dh 64 and 128, T a multiple of the tile and ragged, causal
and not, Tk != Tq (top-left causal), run-to-run bit identity of the
forward and the backward (T 200 and 1000 ragged), the backward at a
negative and a small scale and replayed from a CUDA graph bit for bit (Dh
64 and 128), and the wrappers' input checks; the f32-precise kernels
(``DSTPU_FLASH_F32_PRECISE=1``) in every element type at the 774M and Dh
128 / T 2048 widths and at ragged tails, in 16 bits nearer an f64
evaluation than kernels D, E, F on the same inputs (mean error over every
element, the default's PRECISE_GAIN times the precise one's or more), and
the flag's route through the autograd path; the chunked LM loss's bf16
backward against f32; a bf16 LLaMA engine's checkpoint round trip on the
card; ZeRO-Offload on the card (a small bf16 LLaMA trained with device
state, cpu and nvme offload from one init: the first loss bit-identical,
cpu within 1e-3 of the device state and its images within 1e-2 row by row,
nvme bit for bit with cpu; the staging slots pinned and only the bf16
images on the card); the flash kernels at GPT-2 774M's random-LTD shape
(B·H 8·20, T_keep 512, Dh 64, bf16, causal), and a small GPT-2 trained
with random-LTD and with PLD on the card launching them at the kept
length; the FLOPs profiler's count of a small GPT-2 on the card equal to
its count on the CPU, forward and forward + backward.
Flash-decode (both computations:
GQA rep >= 2 with p rounded, rep 1 in f32): bf16/f16/f32 at Dh 64, 128 and
256, the CodeLlama-34B decode shape (B 1 and 4, Hq 64 / Hkv 8, S 640), an
odd S, a rep that is not a multiple of the kernel's 8 rows, idx at 0, a
split edge and S - 1, the index as a python int and as a device tensor
(the same bits), values past idx that must not change the output (the
kernel never reads them), run-to-run bit identity, and the wrapper's input
checks; the GQA computation at its split edges (idx 0, chunk - 1, chunk,
S - 1, S and past it) for rep 2 to 16, Dh 64 to 256 and every element
type, replayed from a CUDA graph after the device idx changes, and equal
bit for bit to the fused decode step (kernel B, the same body) on the same
cache under the same plan. Block-sparse attention (forward, backward dQ, backward dK/dV):
bf16, f16 and f32 at block 16, 32 and 64 and Dh 64 and 128, causal and not,
over Fixed, BigBird and Longformer layouts (global rows much longer than
the others) and a hand-made layout whose rows of one block see no key under
causal (zeros, lse -1e30), held row by row against the plain versions and
bit for bit across two launches; dK/dV at layouts whose global columns and
the forward and dQ at layouts whose global rows are cut in parts of the
work list (combined by the merge launch), bit for bit on a repeat, the
forward with its merge replayed from a CUDA graph; the autograd
path's launch counts; the dense oracle. The gridded int8 matmul against its plain version at ragged
shapes and at every N from 1 to 32 (ragged D 384 and 1408), each row the
same bits whatever the batch, and the wrappers' input checks (a shape the
kernels do not take raises and launches nothing: there is no fallback).

Tolerances: caches bit-identical (block pools: every row but the garbage
row, which several inactive slots may write at once); flash outputs and
grads, row by row, within 2e-2 (bf16), 4e-3 (f16), 1e-4 (f32) of the row's
own max |ref| (``kernel_check.rel_err``: about two ulps of the row's
largest element; p and dS are rounded at the same points in kernel and
plain version, but the forward's p at tile-local maxima, and sums run in
another order), lse within 1e-4 absolute; decode outputs (both decode steps), row by
row, within 2e-2 (bf16), 4e-3 (f16), 1e-5 (f32) of the row's own max |ref|
(``kernel_check.rel_err``: the kernels round p at chunk- or warp-local
running maxima, the plain version at the row maximum; f32 differs in
summation order only); int8 matmul
outputs within one ulp of the output type (rtol 8e-3 bf16, 1e-3 f16,
1e-5 f32) plus 1e-3 absolute. Block-sparse outputs and grads, row by row,
within 1.6e-2 (bf16) and 2e-3 (f16): two ulps of the row's largest element
(kernel and plain version both compute in f32 and round once, so they
differ by at most one), and 1e-5 (f32: summation order only); lse within
1e-4 absolute.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops.decode_step import (block_split_plan,
                                                 fused_block_decode_step,
                                                 fused_block_decode_step_plain,
                                                 fused_decode_step,
                                                 fused_decode_step_plain,
                                                 split_plan)
from deepspeed_tpu_torch.ops.flash_decode import (flash_decode,
                                                  flash_decode_mha,
                                                  flash_decode_plain, plan)
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_bwd_dkv,
                                                     flash_bwd_dkv_plain,
                                                     flash_bwd_dkv_precise,
                                                     flash_bwd_dq,
                                                     flash_bwd_dq_plain,
                                                     flash_bwd_dq_precise,
                                                     flash_fwd_parts,
                                                     flash_fwd_parts_plain,
                                                     flash_fwd_precise)
from deepspeed_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                 int8_matmul_dma,
                                                 int8_matmul_plain)
from deepspeed_tpu_torch.ops.kernel_check import (PRECISE_GAIN,
                                                  block_step_inputs,
                                                  capture_graph, clone_pool,
                                                  dq_by_parts, fwd_by_parts,
                                                  flash_delta, flash_inputs,
                                                  flash_mean_errors_f64,
                                                  graph_replay,
                                                  masked_row_layout,
                                                  real_rows_equal, rel_err)
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, FixedSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import (
    block_sparse_attention, block_sparse_attention_reference,
    block_sparse_bwd_dkv, block_sparse_bwd_dkv_plain, block_sparse_bwd_dq,
    block_sparse_bwd_dq_plain, block_sparse_delta, block_sparse_fwd,
    block_sparse_fwd_plain, sparse_luts)

pytestmark = pytest.mark.cuda

DECODE_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3, torch.float32: 1e-5}
# the CodeLlama-34B row's S, Hkv and a batch at which the split plan takes
# the smallest chunk on any card of at least 80 SMs (4 blocks per SM)
SPLIT_B, SPLIT_HKV, SPLIT_S = 6, 2, 300
MATMUL_RTOL = {torch.bfloat16: 8e-3, torch.float16: 1e-3, torch.float32: 1e-5}
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3, torch.float32: 1e-4}
# the f32-precise flash kernels: the f32 bound, plus one ulp of a 16-bit
# output as a share of the row's max (the same f32 values rounded once may
# land one ulp apart; an element in [2^e, 2^(e+1)) has an ulp of 2^(e-7)
# in bf16, 2^(e-10) in fp16)
PRECISE_TOL = {torch.bfloat16: 1e-4 + 2 ** -7, torch.float16: 1e-4 + 2 ** -10,
               torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _decode_inputs(dev, dtype, b, hq, hkv, s, dh, layers=2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (rnd(b, 1, hq, dh), rnd(layers, b, hkv, s, dh),
            rnd(layers, b, hkv, s, dh), rnd(b, 1, hkv, dh),
            rnd(b, 1, hkv, dh))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("b,hq,hkv,s,dh", [
    (3, 4, 4, 200, 64),      # MHA, S not a multiple of the chunk
    (4, 8, 2, 300, 128),     # GQA rep 4
    (2, 4, 1, 129, 256),     # rep 4 x Dh 256
])
def test_decode_step_matches_plain(cuda, dtype, b, hq, hkv, s, dh):
    q, kf, vf, kn, vn = _decode_inputs(cuda, dtype, b, hq, hkv, s, dh)
    idx = [0, s - 1, s, s // 2][:b]
    for form in (torch.tensor(idx, dtype=torch.int32, device=cuda), idx[1]):
        k1, v1, k2, v2 = kf.clone(), vf.clone(), kf.clone(), vf.clone()
        out, _, _ = fused_decode_step(q, k1, v1, kn, vn, 1, form)
        ref, _, _ = fused_decode_step_plain(q, k2, v2, kn, vn, 1, form)
        torch.cuda.synchronize()
        assert torch.equal(k1, k2) and torch.equal(v1, v2)
        err = rel_err(out, ref)
        assert err <= DECODE_TOL[dtype], err


def test_decode_step_rows_are_independent(cuda):
    q, kf, vf, kn, vn = _decode_inputs(cuda, torch.bfloat16, 4, 8, 8, 256, 128)
    idx = torch.tensor([100, 7, 255, 30], dtype=torch.int32, device=cuda)
    out, _, _ = fused_decode_step(q, kf.clone(), vf.clone(), kn, vn, 0, idx)
    kf2, vf2 = kf.clone(), vf.clone()
    kf2[:, 1:] = -kf2[:, 1:]                  # other slots' caches change
    idx2 = idx.clone()
    idx2[1:] = torch.tensor([3, 99, 200], dtype=torch.int32, device=cuda)
    out2, _, _ = fused_decode_step(q, kf2, vf2, kn, vn, 0, idx2)
    assert torch.equal(out[0], out2[0])


def test_decode_step_counts_launches_and_rejects_bad_inputs(cuda):
    q, kf, vf, kn, vn = _decode_inputs(cuda, torch.bfloat16, 2, 4, 4, 64, 64)
    n0 = fused_decode_step.launches
    fused_decode_step(q, kf, vf, kn, vn, 0, 5)
    assert fused_decode_step.launches == n0 + 1
    with pytest.raises(ValueError):     # int64 idx
        fused_decode_step(q, kf, vf, kn, vn, 0,
                          torch.tensor([1, 2], device=cuda))
    with pytest.raises(ValueError):     # non-contiguous cache
        fused_decode_step(q, kf.transpose(3, 4), vf, kn, vn, 0, 5)
    with pytest.raises(ValueError):     # layer out of range
        fused_decode_step(q, kf, vf, kn, vn, 2, 5)
    assert fused_decode_step.launches == n0 + 1


def _poison_past(cache, idx):
    """A copy of a [L, B, Hkv, S, Dh] cache with every position past each
    slot's idx set to 1e4: a kernel that reads one moves the output."""
    out = cache.clone()
    for b, i in enumerate(idx):
        out[:, b, :, max(int(i), -1) + 1:] = 1e4
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("hq,hkv,dh", [
    (2, 2, 128),      # rep 1
    (8, 2, 128),      # rep 4
    (16, 2, 128),     # rep 8 (CodeLlama-34B's)
    (32, 2, 128),     # rep 16: two n-tiles
    (16, 2, 64),      # rep 8 at Dh 64
    (64, 2, 64),      # rep 32 at Dh 64: four n-tiles
    (4, 2, 40),       # a Dh that is no multiple of 16 (CUDA-core body)
])
def test_decode_step_split_boundaries(cuda, dtype, hq, hkv, dh):
    """Positions at and around the split edges, S - 1, S (the dropped write)
    and 0 beside S - 1, in one launch; the cache beyond each idx poisoned
    and left unread; two launches equal bit for bit; the scalar index the
    same bits as the device tensor."""
    b, s = SPLIT_B, SPLIT_S
    chunk, n_splits = split_plan(b, hkv, s, torch.cuda.get_device_properties(
        cuda).multi_processor_count, dh, dtype.itemsize)
    assert n_splits > 1, (chunk, n_splits)
    q, kf, vf, kn, vn = _decode_inputs(cuda, dtype, b, hq, hkv, s, dh)
    idx = [chunk - 1, chunk, chunk + 1, s - 1, s, 0]
    iv = torch.tensor(idx, dtype=torch.int32, device=cuda)
    k1, v1, k2, v2 = kf.clone(), vf.clone(), kf.clone(), vf.clone()
    out, _, _ = fused_decode_step(q, k1, v1, kn, vn, 1, iv)
    ref, _, _ = fused_decode_step_plain(q, k2, v2, kn, vn, 1, iv)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert torch.isfinite(out.float()).all()
    assert rel_err(out, ref) <= DECODE_TOL[dtype]
    again, _, _ = fused_decode_step(q, kf.clone(), vf.clone(), kn, vn, 1, iv)
    assert torch.equal(again, out), "not bit-identical run to run"
    # K/V past idx poisoned (the slot at idx S has nothing past it)
    kp, vp = _poison_past(kf, idx), _poison_past(vf, idx)
    poisoned, _, _ = fused_decode_step(q, kp, vp, kn, vn, 1, iv)
    assert torch.equal(poisoned, out), "the kernel read past idx"
    for i in (chunk, s - 1, s):                   # the scalar form
        form, _, _ = fused_decode_step(q, kf.clone(), vf.clone(), kn, vn, 1, i)
        dev, _, _ = fused_decode_step(
            q, kf.clone(), vf.clone(), kn, vn, 1,
            torch.full((b,), i, dtype=torch.int32, device=cuda))
        assert torch.equal(form, dev), i


def test_decode_step_one_launch_per_call(cuda):
    q, kf, vf, kn, vn = _decode_inputs(cuda, torch.bfloat16, SPLIT_B, 16,
                                       SPLIT_HKV, SPLIT_S, 128)
    iv = torch.tensor([5, 70, 299, 300, 0, 128], dtype=torch.int32,
                      device=cuda)
    n0 = fused_decode_step.launches
    for i in range(3):
        fused_decode_step(q, kf, vf, kn, vn, 0, iv)
        assert fused_decode_step.launches == n0 + i + 1


def test_decode_step_replays_in_a_cuda_graph(cuda):
    """A call captured in a CUDA graph, replayed after the device idx
    changes, equals the eager call on the new idx (the split plan reads no
    idx on the host, the scratch comes from the graph's pool)."""
    b, hq, hkv, s, dh = SPLIT_B, 16, SPLIT_HKV, SPLIT_S, 128
    q, kf, vf, kn, vn = _decode_inputs(cuda, torch.bfloat16, b, hq, hkv, s, dh)
    iv = torch.tensor([0, 63, 64, 299, 300, 150], dtype=torch.int32,
                      device=cuda)
    kg, vg = kf.clone(), vf.clone()
    graph, (out_g, _, _) = capture_graph(
        lambda: fused_decode_step(q, kg, vg, kn, vn, 1, iv))
    for new in ([5, 200, 64, 1, 0, 299], [299, 0, 300, 130, 63, 64]):
        kg.copy_(kf)
        vg.copy_(vf)
        iv.copy_(torch.tensor(new, dtype=torch.int32, device=cuda))
        graph.replay()
        ke, ve = kf.clone(), vf.clone()
        eager, _, _ = fused_decode_step(q, ke, ve, kn, vn, 1, iv)
        torch.cuda.synchronize()
        assert torch.equal(out_g, eager), new
        assert torch.equal(kg, ke) and torch.equal(vg, ve), new


@pytest.mark.parametrize("dtype,kv", [
    (torch.bfloat16, None), (torch.float16, None), (torch.float32, None),
    (torch.bfloat16, "int8"), (torch.bfloat16, "fp8"),
    (torch.float32, "int8"), (torch.float32, "fp8")])
@pytest.mark.parametrize("b,hq,hkv,bs,mb,dh", [
    (5, 4, 4, 16, 8, 128),     # MHA
    (4, 8, 2, 16, 6, 64),      # GQA rep 4, Dh 64
    (3, 4, 1, 32, 4, 128),     # rep 4, wider blocks
])
def test_block_decode_step_matches_plain(cuda, dtype, kv, b, hq, hkv, bs, mb,
                                         dh):
    nblk = (b - 1) * mb + 3
    _, q, kp, vp, kn, vn, table = block_step_inputs(cuda, dtype, kv, b, hq,
                                                    hkv, nblk, bs, mb, dh)
    s = mb * bs
    # position 0, a block edge, the table's last row, a mid position, and
    # the last slot (sentinel table) past the table width: the garbage row
    idx = [0, bs, s - 1, bs + 3][:b - 1] + [s]
    iv = torch.tensor(idx, dtype=torch.int32, device=cuda)
    k1, v1 = clone_pool(kp), clone_pool(vp)
    k2, v2 = clone_pool(kp), clone_pool(vp)
    out, _, _ = fused_block_decode_step(q, k1, v1, kn, vn, 1, iv, table)
    ref, _, _ = fused_block_decode_step_plain(q, k2, v2, kn, vn, 1, iv, table)
    torch.cuda.synchronize()
    assert real_rows_equal(k1, k2) and real_rows_equal(v1, v2)
    assert not real_rows_equal(k1, kp)          # the writes landed
    err = rel_err(out, ref)
    assert err <= DECODE_TOL[dtype], err


def test_block_decode_step_rows_are_independent(cuda):
    _, q, kp, vp, kn, vn, table = block_step_inputs(
        cuda, torch.bfloat16, "int8", 3, 8, 8, 40, 16, 8, 128)
    idx = torch.tensor([100, 7, 30], dtype=torch.int32, device=cuda)
    out, _, _ = fused_block_decode_step(q, clone_pool(kp), clone_pool(vp), kn, vn, 0,
                                        idx, table)
    idx2 = idx.clone()
    idx2[1:] = torch.tensor([3, 120], dtype=torch.int32, device=cuda)
    table2 = table.clone()
    table2[1:] = table2[1:].flip(1)
    out2, _, _ = fused_block_decode_step(q, clone_pool(kp), clone_pool(vp), kn, vn, 0,
                                         idx2, table2)
    assert torch.equal(out[0], out2[0])


def test_block_decode_step_counts_launches_and_rejects_bad_inputs(cuda):
    _, q, kp, vp, kn, vn, table = block_step_inputs(
        cuda, torch.bfloat16, "fp8", 2, 4, 4, 8, 16, 4, 64)
    iv = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    n0 = fused_block_decode_step.launches
    fused_block_decode_step(q, kp, vp, kn, vn, 0, iv, table)
    assert fused_block_decode_step.launches == n0 + 1
    with pytest.raises(ValueError):     # int64 table
        fused_block_decode_step(q, kp, vp, kn, vn, 0, iv, table.long())
    with pytest.raises(ValueError):     # one pool quantized, one not
        fused_block_decode_step(q, kp, vp["q"], kn, vn, 0, iv, table)
    with pytest.raises(ValueError):     # f32 scales
        fused_block_decode_step(q, {"q": kp["q"], "s": kp["s"].float()}, vp,
                                kn, vn, 0, iv, table)
    with pytest.raises(ValueError):     # layer out of range
        fused_block_decode_step(q, kp, vp, kn, vn, 2, iv, table)
    assert fused_block_decode_step.launches == n0 + 1


def _active_block_inputs(dev, dtype, kv, b, hq, hkv, bs, mb, dh, seed=0):
    """block_step_inputs with every one of the ``b`` slots on its own real
    table (its last, sentinel-table slot dropped)."""
    _, q, kp, vp, kn, vn, table = block_step_inputs(
        dev, dtype, kv, b + 1, hq, hkv, b * mb, bs, mb, dh, seed=seed)
    return q[:b], kp, vp, kn[:b], vn[:b], table[:b].contiguous()


def _garbage_rows(pool, rows):
    """Rows ``rows`` of the garbage row at layer 1: payload and scales."""
    if isinstance(pool, dict):
        return pool["q"][1, -1, :, rows], pool["s"][1, -1, :, rows]
    return (pool[1, -1, :, rows],)


@pytest.mark.parametrize("dtype,kv", [
    (torch.bfloat16, None), (torch.bfloat16, "int8"), (torch.bfloat16, "fp8"),
    (torch.float16, "int8"), (torch.float32, None), (torch.float32, "fp8")])
@pytest.mark.parametrize("hq,hkv,dh", [(8, 8, 128), (8, 2, 128), (16, 2, 64)])
def test_block_decode_step_split_edges(cuda, dtype, kv, hq, hkv, dh):
    """idx at the last and first positions of splits, MB*bs - 1, 0, and two
    overflow slots (written to rows of the garbage row by split 0): pool
    bytes bit-identical to the plain version's (every real row and the two
    written garbage rows), output row by row, two launches bit for bit."""
    b, bs, mb = 8, 16, 32
    s = mb * bs
    chunk, n_splits = block_split_plan(b, hkv, s, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert n_splits > 1, (chunk, n_splits)
    q, kp, vp, kn, vn, table = _active_block_inputs(cuda, dtype, kv, b, hq, hkv,
                                                    bs, mb, dh)
    idx = [chunk - 1, chunk, 2 * chunk - 1, s - 1, s, s + 6, 0, 2 * chunk + 3]
    iv = torch.tensor(idx, dtype=torch.int32, device=cuda)
    k1, v1 = clone_pool(kp), clone_pool(vp)
    k2, v2 = clone_pool(kp), clone_pool(vp)
    out, _, _ = fused_block_decode_step(q, k1, v1, kn, vn, 1, iv, table)
    ref, _, _ = fused_block_decode_step_plain(q, k2, v2, kn, vn, 1, iv, table)
    again, _, _ = fused_block_decode_step(q, clone_pool(kp), clone_pool(vp), kn,
                                          vn, 1, iv, table)
    torch.cuda.synchronize()
    assert real_rows_equal(k1, k2) and real_rows_equal(v1, v2)
    written = [s % bs, (s + 6) % bs]
    for a, r in ((k1, k2), (v1, v2)):
        for x, y in zip(_garbage_rows(a, written), _garbage_rows(r, written)):
            assert torch.equal(x, y)
    assert not torch.equal(_garbage_rows(k1, written)[0],
                           _garbage_rows(kp, written)[0])   # the writes landed
    assert torch.isfinite(out.float()).all()
    assert rel_err(out, ref) <= DECODE_TOL[dtype]
    assert torch.equal(again, out), "not bit-identical run to run"


def test_block_decode_step_replays_in_a_cuda_graph(cuda):
    """A call captured in a CUDA graph, replayed after the device idx and
    table change, equals the eager call on the new ones (the split plan
    reads neither on the host; the scratch comes from the graph's pool)."""
    b, hq, hkv, bs, mb, dh = 6, 16, 2, 16, 20, 128
    q, kp, vp, kn, vn, table = _active_block_inputs(
        cuda, torch.bfloat16, "int8", b, hq, hkv, bs, mb, dh)
    iv = torch.tensor([0, 63, 64, 319, 320, 150], dtype=torch.int32, device=cuda)
    tg = table.clone()
    kg, vg = clone_pool(kp), clone_pool(vp)
    graph, (out_g, _, _) = capture_graph(
        lambda: fused_block_decode_step(q, kg, vg, kn, vn, 1, iv, tg))
    for new, flip in (([5, 200, 64, 1, 0, 319], False),
                      ([319, 0, 330, 130, 63, 64], True)):
        for dst, src in ((kg, kp), (vg, vp)):
            for key in ("q", "s"):
                dst[key].copy_(src[key])
        iv.copy_(torch.tensor(new, dtype=torch.int32, device=cuda))
        tg.copy_(table.flip(1) if flip else table)
        graph.replay()
        ke, ve = clone_pool(kp), clone_pool(vp)
        eager, _, _ = fused_block_decode_step(q, ke, ve, kn, vn, 1, iv, tg)
        torch.cuda.synchronize()
        assert torch.equal(out_g, eager), new
        assert real_rows_equal(kg, ke) and real_rows_equal(vg, ve), new


def _mm_inputs(dev, dtype, n, d, e, layers=2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-128, 128, (layers, d, e), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((layers, 1, e), generator=g, device=dev) * 0.02
    x = torch.randn((n, d), generator=g, device=dev).to(dtype)
    return x, q, s


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("n,d,e", [(1, 512, 1408), (3, 640, 256),
                                   (8, 4096, 4096), (17, 384, 2048),
                                   (32, 1024, 11008), (5, 1001, 656)])
def test_int8_matmul_matches_plain(cuda, dtype, n, d, e):
    x, q, s = _mm_inputs(cuda, dtype, n, d, e)
    out = int8_matmul_dma(x, q, s, 1)
    ref = int8_matmul_plain(x, q, s, 1)
    err = (out.float() - ref.float()).abs()
    assert (err <= MATMUL_RTOL[dtype] * ref.float().abs() + 1e-3).all(), \
        err.max().item()
    # the unstacked form on the same layer
    out2 = int8_matmul_dma(x, q[1].contiguous(), s[1].reshape(-1).contiguous())
    assert torch.equal(out, out2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("n", range(1, 33))
def test_int8_matmul_every_batch_width(cuda, dtype, n):
    """Every N the kernel takes (its n-tiles: 1-8, 9-16, 17-24, 25-32), at
    ragged D (384 and 1408: slabs and stages cut short) and E (a last
    column tile cut short), on the last of three stacked layers, against
    the plain version."""
    for d, e in ((384, 2064), (1408, 640)):
        x, q, s = _mm_inputs(cuda, dtype, n, d, e, layers=3, seed=n)
        out = int8_matmul_dma(x, q, s, 2)
        ref = int8_matmul_plain(x, q, s, 2)
        err = (out.float() - ref.float()).abs()
        assert (err <= MATMUL_RTOL[dtype] * ref.float().abs() + 1e-3).all(), \
            (d, e, err.max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_int8_matmul_row_result_independent_of_batch(cuda, dtype):
    """A row's result is the same bits whatever the batch around it (every
    N from 1 to 32) and run to run: the plan depends on (D, E) alone and
    the split-K sum runs in a fixed order."""
    for d, e in ((1024, 2048), (4096, 11008)):
        x, q, s = _mm_inputs(cuda, dtype, 32, d, e)
        full = int8_matmul_dma(x, q, s, 0)
        assert torch.equal(int8_matmul_dma(x, q, s, 0), full)
        for n in range(1, 32):
            assert torch.equal(int8_matmul_dma(x[:n].contiguous(), q, s, 0),
                               full[:n]), (d, e, n)


def test_int8_matmul_rejects_bad_inputs(cuda):
    x, q, s = _mm_inputs(cuda, torch.bfloat16, 33, 256, 512)
    n0 = int8_matmul_dma.launches
    with pytest.raises(ValueError):     # > 32 rows
        int8_matmul_dma(x, q, s, 0)
    with pytest.raises(ValueError):     # stacked without a layer
        int8_matmul_dma(x[:4].contiguous(), q, s)
    with pytest.raises(TypeError):      # bf16 scales
        int8_matmul_dma(x[:4].contiguous(), q, s.to(torch.bfloat16), 0)
    assert int8_matmul_dma.launches == n0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("tq,tk", [(128, 128), (48, 48), (200, 200),
                                   (1000, 1000), (96, 160), (160, 96)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_match_plain(cuda, dtype, dh, tq, tk, causal):
    q, k, v, do = flash_inputs(cuda, dtype, 6, tq, dh, tk=tk, seed=tq + dh)
    out, lse = flash_fwd_parts(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd_parts_plain(q, k, v, causal=causal)
    assert rel_err(out, ref) <= FLASH_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    delta = flash_delta(do, ref)
    dq = flash_bwd_dq(q, k, v, do, ref_lse, delta, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal=causal)
    rdq = flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal=causal)
    rdk, rdv = flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, causal=causal)
    torch.cuda.synchronize()
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(got.float()).all()
        assert rel_err(got, want) <= FLASH_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("t", [200, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_ragged_and_bit_identical(cuda, dtype, dh, t, causal):
    """The forward at T that is no multiple of the 64-row tile (TMA's zero
    fill of the tail), held row by row, and two launches bit for bit."""
    q, k, v, _ = flash_inputs(cuda, dtype, 4, t, dh, seed=t + dh)
    out, lse = flash_fwd_parts(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd_parts_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert rel_err(out, ref) <= FLASH_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    out2, lse2 = flash_fwd_parts(q, k, v, causal=causal)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("scale", [-0.3, 0.05])
def test_flash_forward_takes_any_scale(cuda, scale):
    """The forward takes the tile's max on the raw scores, so a negative
    scale (the max of s * scale is scale * min s) must be handled apart."""
    q, k, v, _ = flash_inputs(cuda, torch.bfloat16, 4, 200, 64, seed=7)
    for causal in (True, False):
        out, lse = flash_fwd_parts(q, k, v, causal=causal, scale=scale)
        ref, ref_lse = flash_fwd_parts_plain(q, k, v, causal=causal,
                                             scale=scale)
        torch.cuda.synchronize()
        assert rel_err(out, ref) <= FLASH_TOL[torch.bfloat16]
        assert (lse - ref_lse).abs().max().item() <= 1e-4


def _flash_bwd(q, k, v, do, lse, delta, causal, scale=None):
    return (flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale),
            *flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale))


def test_flash_backward_is_bit_identical_run_to_run(cuda):
    q, k, v, do = flash_inputs(cuda, torch.bfloat16, 8, 300, 64)
    out, lse = flash_fwd_parts(q, k, v, causal=True)
    delta = flash_delta(do, out)
    first = _flash_bwd(q, k, v, do, lse, delta, True)
    again = _flash_bwd(q, k, v, do, lse, delta, True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_backward_graph_replay_is_bit_identical(cuda, dtype, dh):
    """The backward captured in a CUDA graph and replayed gives the eager
    launch's bits: no atomics, every element summed in a fixed order."""
    q, k, v, do = flash_inputs(cuda, dtype, 8, 1000, dh, seed=3)
    out, lse = flash_fwd_parts(q, k, v, causal=True)
    delta = flash_delta(do, out)
    eager = _flash_bwd(q, k, v, do, lse, delta, True)
    replayed = graph_replay(lambda: _flash_bwd(q, k, v, do, lse, delta, True))
    assert all(torch.equal(a, b) for a, b in zip(eager, replayed))


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("scale", [-0.3, 0.05])
def test_flash_backward_takes_any_scale(cuda, scale, dh):
    """The backward folds scale * log2(e) into one FFMA before the ex2;
    a negative scale must come out as the plain version's."""
    q, k, v, do = flash_inputs(cuda, torch.bfloat16, 4, 200, dh, seed=11)
    for causal in (True, False):
        ref, lse = flash_fwd_parts_plain(q, k, v, causal=causal, scale=scale)
        delta = flash_delta(do, ref)
        got = _flash_bwd(q, k, v, do, lse, delta, causal, scale)
        want = (flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                                   scale=scale),
                *flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                                     scale=scale))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.isfinite(g.float()).all()
            assert rel_err(g, w) <= FLASH_TOL[torch.bfloat16]


def test_flash_attention_autograd_runs_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 130, 4, 64), generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    n = (flash_fwd_parts.launches, flash_bwd_dq.launches,
         flash_bwd_dkv.launches)
    out = flash_attention(q, k, v, True)
    out.float().square().sum().backward()
    assert (flash_fwd_parts.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    for t in (q, k, v):
        assert t.grad.shape == t.shape and torch.isfinite(t.grad.float()).all()


def test_flash_wrappers_reject_bad_inputs(cuda, monkeypatch):
    q, k, v, do = flash_inputs(cuda, torch.bfloat16, 2, 64, 64)
    n0 = flash_fwd_parts.launches
    with pytest.raises(ValueError):     # Dh 96
        flash_fwd_parts(*flash_inputs(cuda, torch.bfloat16, 2, 64, 96)[:3],
                        causal=True)
    with pytest.raises(ValueError):     # float64
        flash_fwd_parts(q.double(), k.double(), v.double(), causal=True)
    with pytest.raises(ValueError):     # non-contiguous
        flash_fwd_parts(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                        v, causal=True)
    with pytest.raises(ValueError):     # mixed dtypes
        flash_fwd_parts(q, k.half(), v, causal=True)
    assert flash_fwd_parts.launches == n0
    # under the flag the wrapper launches the f32-precise kernel instead,
    # and the precise wrappers check their inputs the same way
    monkeypatch.setenv("DSTPU_FLASH_F32_PRECISE", "1")
    p0 = flash_fwd_precise.launches
    flash_fwd_parts(q, k, v, causal=True)
    assert flash_fwd_parts.launches == n0
    assert flash_fwd_precise.launches == p0 + 1
    with pytest.raises(ValueError):     # Dh 96
        flash_fwd_precise(*flash_inputs(cuda, torch.bfloat16, 2, 64, 96)[:3],
                          causal=True)
    assert flash_fwd_precise.launches == p0 + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("dh,t,bh", [(64, 1024, 4), (128, 2048, 2),
                                     (64, 130, 3), (128, 77, 3)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_precise_kernels_match_plain(cuda, dtype, dh, t, bh, causal):
    """The f32-precise kernels against the plain versions with p and dS in
    f32, row by row: at the 774M and Dh 128 / T 2048 widths and at tails no
    multiple of the 32-row tile. In 16 bits, the precise kernels and the
    default ones, each run end to end, against an f64 evaluation: the
    precise ones keep p and dS in f32, so their mean error is the smaller
    by PRECISE_GAIN or more."""
    q, k, v, do = flash_inputs(cuda, dtype, bh, t, dh, seed=t + dh)
    out, lse = flash_fwd_precise(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd_parts_plain(q, k, v, causal=causal, precise=True)
    delta = flash_delta(do, ref)
    got = (flash_bwd_dq_precise(q, k, v, do, ref_lse, delta, causal=causal),
           *flash_bwd_dkv_precise(q, k, v, do, ref_lse, delta, causal=causal))
    want = (flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal=causal,
                               precise=True),
            *flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, causal=causal,
                                 precise=True))
    torch.cuda.synchronize()
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    for g, w in ((out, ref),) + tuple(zip(got, want)):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        assert rel_err(g, w) <= PRECISE_TOL[dtype]
    again = flash_bwd_dq_precise(q, k, v, do, ref_lse, delta, causal=causal)
    assert torch.equal(again, got[0])
    if dtype == torch.float32:
        return
    errs = []
    for fwd, dq, dkv in ((flash_fwd_precise, flash_bwd_dq_precise,
                          flash_bwd_dkv_precise),
                         (flash_fwd_parts, flash_bwd_dq, flash_bwd_dkv)):
        o, lse = fwd(q, k, v, causal=causal)
        d = flash_delta(do, o)
        outs = (o, dq(q, k, v, do, lse, d, causal=causal),
                *dkv(q, k, v, do, lse, d, causal=causal))
        errs.append(flash_mean_errors_f64(outs, q, k, v, do, causal=causal))
    for name, ep, ed in zip(("o", "dq", "dk", "dv"), *errs):
        assert ed >= PRECISE_GAIN * ep, (name, ep, ed)


def test_flash_precise_flag_routes_the_autograd_path(cuda, monkeypatch):
    monkeypatch.setenv("DSTPU_FLASH_F32_PRECISE", "1")
    wrappers = (flash_fwd_parts, flash_bwd_dq, flash_bwd_dkv,
                flash_fwd_precise, flash_bwd_dq_precise, flash_bwd_dkv_precise)
    before = [w.launches for w in wrappers]
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 200, 4, 64), generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    flash_attention(q, k, v, True).float().square().sum().backward()
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [0, 0, 0, 1, 1, 1]


def test_chunked_loss_backward_sums_in_f32(cuda):
    """The chunked LM loss's backward in bf16 at GPT-2 774M's vocabulary and
    width (1024 rows a chunk) against the same from f32 copies of the same
    values: the gradients of the hidden states and of the embedding each
    within 2^-7 of their norm (dl and each result rounded to bf16 once,
    2^-9 apiece)."""
    from deepspeed_tpu_torch.runtime.zero.tiling import chunked_cross_entropy

    g = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn((8, 256, 1280), generator=g, device=cuda).to(torch.bfloat16)
    e = (torch.randn((50257, 1280), generator=g, device=cuda) * 0.02
         ).to(torch.bfloat16)
    labels = torch.randint(0, 50257, (8, 256), generator=g, device=cuda)
    grads = []
    for dtype in (torch.bfloat16, torch.float32):
        hh, ee = (x.detach().to(dtype).requires_grad_() for x in (h, e))
        chunked_cross_entropy(hh, ee, labels, chunk=128)[0].backward()
        grads.append((hh.grad.float(), ee.grad.float()))
    for name, got, want in zip(("hidden", "embed"), *grads):
        err = ((got - want).norm() / want.norm()).item()
        assert err <= 2 ** -7, (name, err)


def test_cuda_engine_checkpoint_round_trip(cuda, tmp_path):
    """A bf16 LLaMA engine on the card: save, load into a fresh engine (every
    master and moment bit for bit, on the card) and continue; the resumed
    losses equal the uninterrupted run's (the step's kernels are
    deterministic: the flash backward sums without atomics)."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "bf16": {"enabled": True}, "steps_per_print": 0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(4):
        ids = rng.randint(0, 512, size=(2, 2, 129)).astype(np.int32)
        batches.append({"input_ids": ids[..., :-1], "labels": ids[..., 1:]})

    def engine(seed):
        model = LlamaModel(LlamaConfig(vocab_size=512, max_seq_len=128,
                                       num_layers=2, hidden_size=256,
                                       num_heads=4, num_kv_heads=2,
                                       intermediate_size=512),
                           attn_impl="flash")
        return deepspeed_tpu_torch.initialize(
            model=model, config={**cfg, "seed": seed})[0]

    e1 = engine(0)
    [e1.train_batch_from_stacked(b) for b in batches[:2]]
    e1.save_checkpoint(str(tmp_path))
    saved = [t.clone() for t in tree_leaves(e1.state.params)]
    after = [float(e1.train_batch_from_stacked(b)) for b in batches[2:]]
    e2 = engine(1)
    e2.load_checkpoint(str(tmp_path))
    assert all(t.device.type == "cuda" and torch.equal(t, s)
               for t, s in zip(tree_leaves(e2.state.params), saved))
    assert e2.global_steps == 2
    assert [float(e2.train_batch_from_stacked(b)) for b in batches[2:]] == after


def _offload_engines(tmp_path, runs):
    """A bf16 LLaMA (Dh 64, flash) on the card from one init, trained 3
    steps per ``runs`` entry (name, zero section); returns per run the
    losses, grad norms, bf16 images and the engine."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from deepspeed_tpu_torch.runtime.zero.offload import param_names

    cfg = LlamaConfig(vocab_size=512, max_seq_len=128, num_layers=2,
                      hidden_size=256, num_heads=4, num_kv_heads=2,
                      intermediate_size=512)
    params = LlamaModel(cfg).init(torch.Generator(device="cuda").manual_seed(3),
                                  device="cuda", dtype=torch.float32)
    rng = np.random.RandomState(1)
    batches = []
    for _ in range(3):
        ids = rng.randint(0, 512, size=(2, 2, 129)).astype(np.int32)
        batches.append({"input_ids": ids[..., :-1], "labels": ids[..., 1:]})
    out = {}
    for name, zero in runs:
        if zero.get("offload_optimizer", {}).get("device") == "nvme":
            zero["offload_optimizer"]["nvme_path"] = str(tmp_path / name)
        eng = deepspeed_tpu_torch.initialize(
            model=LlamaModel(cfg, attn_impl="flash"), params=params, config={
                "train_batch_size": 4, "gradient_accumulation_steps": 2,
                "bf16": {"enabled": True}, "steps_per_print": 0,
                "gradient_clipping": 1.0, "zero_optimization": zero,
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 1e-4, "weight_decay": 0.01}}})[0]
        rows = [(float(eng.train_batch_from_stacked(b)),
                 eng.get_global_grad_norm()) for b in batches]
        out[name] = dict(rows=rows, engine=eng, images={
            n: p.to(torch.bfloat16) for n, p in param_names(eng.state.params).items()})
    return out


def test_cuda_offload_tracks_device_state(cuda, tmp_path):
    """chip_smoke's train_llama7b_offload (a) at a small width and its lr
    (1e-4): the first loss bit-identical across device-state, cpu and nvme
    offload; cpu against device within 1e-3 relative (losses and grad
    norms of steps 2-3) and the images within 1e-2 row by row (the same f32
    Adam in another order: an ulp of bf16 here and there; at lr 1e-3 a
    step moves these 0.02-sized weights by 8 ulps and the two orders part
    by several); nvme against cpu bit for bit."""
    from deepspeed_tpu_torch.ops.kernel_check import rel_err

    runs = _offload_engines(tmp_path, [
        ("device", {"stage": 0}),
        ("cpu", {"stage": 2, "offload_optimizer": {"device": "cpu"}}),
        ("nvme", {"stage": 3, "offload_optimizer": {"device": "nvme"}})])
    dev, cpu, nvme = (runs[k]["rows"] for k in ("device", "cpu", "nvme"))
    assert dev[0][0] == cpu[0][0] == nvme[0][0]
    for (dl, dn), (cl, cn) in zip(dev[1:], cpu[1:]):
        assert abs(cl - dl) <= 1e-3 * abs(dl) and abs(cn - dn) <= 1e-3 * dn
    for n, img in runs["device"]["images"].items():
        assert rel_err(runs["cpu"]["images"][n], img) <= 1e-2, n
        assert torch.equal(runs["cpu"]["images"][n], runs["nvme"]["images"][n])
    assert nvme == cpu


def test_cuda_offload_stages_pinned_and_keeps_no_f32_on_the_card(cuda, tmp_path):
    """The staging slots are pinned host memory; every parameter on the
    card is a bf16 image, the f32 masters and moments are host tensors, and
    the card holds no more than the images between steps."""
    import gc

    gc.collect()
    base = torch.cuda.memory_allocated()
    runs = _offload_engines(tmp_path, [
        ("cpu", {"stage": 2, "offload_optimizer": {"device": "cpu"}})])
    eng = runs["cpu"]["engine"]
    staging = eng._host_opt.staging
    assert staging is not None and staging.pinned()
    assert all(t.is_pinned() for t in staging.grad + staging.img)
    images = list(runs["cpu"]["images"].values())
    from deepspeed_tpu_torch.runtime.zero.offload import param_names

    assert all(p.device.type == "cuda" and p.dtype == torch.bfloat16
               for p in param_names(eng.state.params).values())
    assert eng.state.opt_state == {}
    assert all(m.device.type == "cpu" and m.dtype == torch.float32
               for m in eng._host_opt.master.values())
    n = sum(t.numel() for t in images)
    del images, runs
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    assert held <= 2 * n + 64 * 2 ** 20, (held, n)


# flash-decode outputs, row by row (kernel_check.rel_err): the kernel rounds
# p at warp-local running maxima, the plain version at the row maximum
FLASH_DECODE_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3,
                    torch.float32: 1e-5}


def _flash_decode_inputs(dev, dtype, b, hq, hkv, s, dh, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return rnd(b, 1, hq, dh), rnd(b, hkv, s, dh), rnd(b, hkv, s, dh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("b,hq,hkv,s,dh", [
    (1, 64, 8, 640, 128),    # CodeLlama-34B decode, batch 1
    (4, 64, 8, 640, 128),    # ... batch 4
    (2, 12, 1, 300, 64),     # rep 12 (two row groups), odd S
    (2, 8, 2, 129, 256),     # Dh 256
    (3, 4, 4, 200, 128),     # rep 1: the f32 variant
])
def test_flash_decode_matches_plain(cuda, dtype, b, hq, hkv, s, dh):
    q, k, v = _flash_decode_inputs(cuda, dtype, b, hq, hkv, s, dh)
    for idx in (0, 31, 32, 127, s // 2, s - 1):
        for form in (idx, torch.tensor(idx, dtype=torch.int32, device=cuda)):
            out = flash_decode(q, k, v, form)
            ref = flash_decode_plain(q, k, v, idx)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all()
            err = rel_err(out, ref)
            assert err <= FLASH_DECODE_TOL[dtype], (idx, err)


def test_flash_decode_ignores_values_past_idx_and_repeats_bits(cuda):
    for hq, hkv in ((64, 8), (8, 8)):
        q, k, v = _flash_decode_inputs(cuda, torch.bfloat16, 2, hq, hkv, 640,
                                       128, seed=1)
        for idx in (0, 127, 128, 500):
            out = flash_decode(q, k, v, idx)
            k2, v2 = k.clone(), v.clone()
            k2[:, :, idx + 1:] = 1e4
            v2[:, :, idx + 1:] = 1e4
            assert torch.equal(flash_decode(q, k2, v2, idx), out)
            assert torch.equal(flash_decode(q, k, v, idx), out)
            dev_idx = torch.tensor(idx, dtype=torch.int32, device=cuda)
            assert torch.equal(flash_decode(q, k, v, dev_idx), out)


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("rep", [2, 4, 8, 16])
def test_flash_decode_split_edges(cuda, dtype, dh, rep):
    """The GQA computation (kernel B's split body) at idx 0, the last and
    first positions of a split, S - 1 and past S, row by row against the
    plain version; the cache past idx poisoned and unread; the device
    index the same bits as the python int. rep 16 at Dh 256 takes two row
    groups."""
    b, hkv, s = 2, 2, 300
    chunk, n_splits = split_plan(b, hkv, s, _sms(cuda), dh, dtype.itemsize)
    assert n_splits > 1, (chunk, n_splits)
    q, k, v = _flash_decode_inputs(cuda, dtype, b, rep * hkv, hkv, s, dh,
                                   seed=rep + dh)
    for idx in (0, chunk - 1, chunk, s - 1, s, s + 7):
        out = flash_decode(q, k, v, idx)
        ref = flash_decode_plain(q, k, v, idx)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), idx
        err = rel_err(out, ref)
        assert err <= FLASH_DECODE_TOL[dtype], (idx, err)
        k2, v2 = k.clone(), v.clone()
        k2[:, :, idx + 1:] = 1e4
        v2[:, :, idx + 1:] = 1e4
        assert torch.equal(flash_decode(q, k2, v2, idx), out), idx
        dev_idx = torch.tensor(idx, dtype=torch.int32, device=cuda)
        assert torch.equal(flash_decode(q, k, v, dev_idx), out), idx


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_decode_mha_split_edges(cuda, dtype, dh):
    """The rep-1 kernel at idx 0, the last and first positions of a split
    (and of a 32-position stage), S - 1 and past S, at an S that is no
    multiple of the stage, row by row against the plain version; values
    past idx set to 1e4 leave the output bit for bit unchanged; the device
    index gives the python int's bits; a second launch repeats them."""
    b, h, s = 2, 3, 300
    chunk, n_splits = plan(b, h, s, _sms(cuda))
    assert n_splits > 1, (chunk, n_splits)
    q, k, v = _flash_decode_inputs(cuda, dtype, b, h, h, s, dh, seed=dh)
    for idx in (0, 31, 32, chunk - 1, chunk, 2 * chunk - 1, s - 1, s, s + 7):
        out = flash_decode(q, k, v, idx)
        ref = flash_decode_plain(q, k, v, idx)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), idx
        err = rel_err(out, ref)
        assert err <= FLASH_DECODE_TOL[dtype], (idx, err)
        k2, v2 = k.clone(), v.clone()
        k2[:, :, idx + 1:] = 1e4
        v2[:, :, idx + 1:] = 1e4
        assert torch.equal(flash_decode(q, k2, v2, idx), out), idx
        dev_idx = torch.tensor(idx, dtype=torch.int32, device=cuda)
        assert torch.equal(flash_decode(q, k, v, dev_idx), out), idx
        assert torch.equal(flash_decode(q, k, v, idx), out), idx


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_mha_one_split_ignores_values_past_idx(cuda, dtype):
    """LLaMA-7B's MHA row (B 8, H 32, S 1024: one split per head) with every
    value past idx set to 1e4: the output keeps its bits, at idx 0, inside
    the first stage, at a stage edge and at S - 1."""
    b, h, s = 8, 32, 1024
    assert plan(b, h, s, _sms(cuda))[1] == 1
    q, k, v = _flash_decode_inputs(cuda, dtype, b, h, h, s, 128, seed=5)
    for idx in (0, 17, 511, 512, 1000, s - 1):
        out = flash_decode(q, k, v, idx)
        ref = flash_decode_plain(q, k, v, idx)
        torch.cuda.synchronize()
        assert rel_err(out, ref) <= FLASH_DECODE_TOL[dtype], idx
        k2, v2 = k.clone(), v.clone()
        k2[:, :, idx + 1:] = 1e4
        v2[:, :, idx + 1:] = 1e4
        assert torch.equal(flash_decode(q, k2, v2, idx), out), idx


def test_flash_decode_replays_in_a_cuda_graph(cuda):
    """A call captured in a CUDA graph, replayed after the device idx
    changes, equals the eager call on the new idx (the plan reads no idx on
    the host, the split scratch comes from the graph's pool)."""
    q, k, v = _flash_decode_inputs(cuda, torch.bfloat16, 1, 64, 8, 640, 128,
                                   seed=3)
    iv = torch.tensor(639, dtype=torch.int32, device=cuda)
    graph, out_g = capture_graph(lambda: flash_decode(q, k, v, iv))
    for new in (0, 63, 64, 300, 639, 700):
        iv.fill_(new)
        graph.replay()
        eager = flash_decode(q, k, v, new)
        torch.cuda.synchronize()
        assert torch.equal(out_g, eager), new


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("b,rep,hkv,dh", [
    (1, 8, 8, 128),       # CodeLlama-34B decode, batch 1
    (4, 8, 8, 128),       # ... batch 4
    (2, 4, 2, 64),
    (2, 16, 2, 64),       # two n-tiles
    (2, 2, 2, 256),
])
def test_flash_decode_equals_the_fused_step(cuda, dtype, b, rep, hkv, dh):
    """The GQA computation and the fused decode step (kernel B) run one
    body under one plan (``split_plan``): on the same cache, with the step
    writing back row idx's own values (one layer), they agree bit for
    bit."""
    s = 640
    q, k, v = _flash_decode_inputs(cuda, dtype, b, rep * hkv, hkv, s, dh,
                                   seed=b + rep)
    for idx in (0, 63, 64, 639, 650):
        row = min(idx, s - 1)
        kn = k[:, :, row].unsqueeze(1).contiguous()
        vn = v[:, :, row].unsqueeze(1).contiguous()
        step, _, _ = fused_decode_step(q, k[None].clone(), v[None].clone(),
                                       kn, vn, 0, idx)
        out = flash_decode(q, k, v, idx)
        torch.cuda.synchronize()
        assert torch.equal(out, step), idx


def test_flash_decode_counts_launches_and_rejects_bad_inputs(cuda):
    q, k, v = _flash_decode_inputs(cuda, torch.bfloat16, 1, 16, 2, 256, 128)
    n0, m0 = flash_decode.launches, flash_decode_mha.launches
    flash_decode(q, k, v, 7)
    assert flash_decode.launches == n0 + 1
    flash_decode(q[:, :, :2], k, v, 7)                # rep 1: the f32 variant
    assert (flash_decode.launches, flash_decode_mha.launches) == (n0 + 1,
                                                                  m0 + 1)
    with pytest.raises(ValueError):     # Dh 96
        flash_decode(*_flash_decode_inputs(cuda, torch.bfloat16, 1, 16, 2,
                                           64, 96), 3)
    with pytest.raises(ValueError):     # int64 index tensor
        flash_decode(q, k, v, torch.tensor(3, device=cuda))
    with pytest.raises(ValueError):     # non-contiguous cache
        flash_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, 3)
    with pytest.raises(ValueError):     # mixed dtypes
        flash_decode(q, k.half(), v, 3)
    with pytest.raises(ValueError):     # the rep-1 wrapper at rep 8
        flash_decode_mha(q, k, v, 3)
    assert (flash_decode.launches, flash_decode_mha.launches) == (n0 + 1,
                                                                  m0 + 1)


SPARSE_TOL = {torch.bfloat16: 1.6e-2, torch.float16: 2e-3, torch.float32: 1e-5}


def _sparse_layout(kind, h, nb, block):
    t = nb * block
    if kind == "fixed":
        return FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=4,
                                   num_global_blocks=1,
                                   attention="unidirectional").make_layout(t)
    if kind == "bigbird":
        return BigBirdSparsityConfig(num_heads=h, block=block, seed=1,
                                     different_layout_per_head=True).make_layout(t)
    if kind == "longformer":
        return BSLongformerSparsityConfig(num_heads=h, block=block,
                                          global_block_indices=[0, 5]).make_layout(t)
    return masked_row_layout(h, nb)


def _sparse_run(cuda, dtype, b, h, nb, block, dh, kind, causal, seed=0):
    """Kernels and plain versions on one input set: returns (kernel
    outputs, plain outputs), each (out, lse, dq, dk, dv)."""
    luts = sparse_luts(_sparse_layout(kind, h, nb, block), cuda)
    q, k, v, do = flash_inputs(cuda, dtype, b * h, nb * block, dh, seed=seed)
    kw = dict(block=block, causal=causal)
    out, lse = block_sparse_fwd(q, k, v, luts, **kw)
    ref, ref_lse = block_sparse_fwd_plain(q, k, v, luts, **kw)
    delta = block_sparse_delta(do, ref)
    got = (out, lse, block_sparse_bwd_dq(q, k, v, do, ref_lse, delta, luts, **kw),
           *block_sparse_bwd_dkv(q, k, v, do, ref_lse, delta, luts, **kw))
    want = (ref, ref_lse,
            block_sparse_bwd_dq_plain(q, k, v, do, ref_lse, delta, luts, **kw),
            *block_sparse_bwd_dkv_plain(q, k, v, do, ref_lse, delta, luts, **kw))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("block", [16, 32, 64])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("kind,causal", [("fixed", True), ("bigbird", False),
                                         ("longformer", True), ("masked", True)])
def test_block_sparse_kernels_match_plain(cuda, dtype, block, dh, kind, causal):
    got, want = _sparse_run(cuda, dtype, 2, 3, 10, block, dh, kind, causal,
                            seed=block + dh)
    assert (got[1] - want[1]).abs().max().item() <= 1e-4
    for name, a, b in zip(("out", "dq", "dk", "dv"), got[:1] + got[2:],
                          want[:1] + want[2:]):
        assert torch.isfinite(a.float()).all(), name
        assert rel_err(a, b) <= SPARSE_TOL[dtype], (name, rel_err(a, b))
    if kind == "masked":          # query block 1 sees no key under causal
        rows = slice(block, 2 * block)
        assert (got[0][:, rows] == 0).all() and (got[2][:, rows] == 0).all()
        assert (got[1][:, rows] <= -1e30).all()


def test_block_sparse_kernels_repeat_bit_for_bit(cuda):
    first, _ = _sparse_run(cuda, torch.bfloat16, 2, 4, 16, 16, 128, "bigbird",
                           False, seed=5)
    again, _ = _sparse_run(cuda, torch.bfloat16, 2, 4, 16, 16, 128, "bigbird",
                           False, seed=5)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("block,nb,dh", [(16, 160, 128), (16, 160, 64),
                                         (32, 144, 64), (64, 136, 128)])
def test_block_sparse_dkv_columns_past_the_part_cap(cuda, dtype, block, nb, dh):
    """dK/dV at a causal Fixed layout whose global columns hold more query
    blocks than one work item takes (up to nb - 3 > 64), so they are cut in
    parts and summed by the merge launch: against the plain version row by
    row, and bit for bit on a repeat."""
    layout = _sparse_layout("fixed", 2, nb, block)
    luts = sparse_luts(layout, cuda)
    assert luts.dkv_slots > 0 and luts.dkv_merge.shape[0] > 0
    q, k, v, do = flash_inputs(cuda, dtype, 2 * 2, nb * block, dh, seed=block)
    kw = dict(block=block, causal=True)
    out, lse = block_sparse_fwd_plain(q, k, v, luts, **kw)
    delta = block_sparse_delta(do, out)
    got = block_sparse_bwd_dkv(q, k, v, do, lse, delta, luts, **kw)
    again = block_sparse_bwd_dkv(q, k, v, do, lse, delta, luts, **kw)
    want = block_sparse_bwd_dkv_plain(q, k, v, do, lse, delta, luts, **kw)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dk", "dv"), got, want, again):
        assert torch.isfinite(a.float()).all(), name
        assert rel_err(a, b) <= SPARSE_TOL[dtype], (name, rel_err(a, b))
        assert torch.equal(a, c), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("block,nb,dh", [(16, 160, 128), (16, 160, 64),
                                         (32, 144, 64), (64, 136, 128)])
@pytest.mark.parametrize("kind,causal", [("bigbird", False),
                                         ("longformer", True)])
def test_block_sparse_dq_rows_past_the_part_cap(cuda, dtype, block, nb, dh,
                                                kind, causal):
    """dQ at layouts whose global rows (BigBird's, Longformer's) hold more
    key blocks than one work item takes (nb > 64), so they are cut in parts
    and summed by the merge launch: against the plain version row by row,
    and bit for bit on a repeat."""
    layout = _sparse_layout(kind, 2, nb, block)
    luts = sparse_luts(layout, cuda)
    assert luts.dq_slots > 0 and luts.dq_merge.shape[0] > 0
    q, k, v, do = flash_inputs(cuda, dtype, 2 * 2, nb * block, dh, seed=block)
    kw = dict(block=block, causal=causal)
    out, lse = block_sparse_fwd_plain(q, k, v, luts, **kw)
    delta = block_sparse_delta(do, out)
    got = block_sparse_bwd_dq(q, k, v, do, lse, delta, luts, **kw)
    again = block_sparse_bwd_dq(q, k, v, do, lse, delta, luts, **kw)
    want = block_sparse_bwd_dq_plain(q, k, v, do, lse, delta, luts, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert rel_err(got, want) <= SPARSE_TOL[dtype], rel_err(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("block,nb,dh", [(16, 160, 128), (16, 160, 64),
                                         (32, 144, 64), (64, 136, 128)])
@pytest.mark.parametrize("kind,causal", [("bigbird", False),
                                         ("longformer", True)])
def test_block_sparse_fwd_rows_past_the_part_cap(cuda, dtype, block, nb, dh,
                                                 kind, causal):
    """The forward at layouts whose global rows (BigBird's, Longformer's)
    hold more key blocks than one work item takes (nb > 64), so they are
    cut in parts whose (acc, m, l) the merge launch combines: out row by row
    and lse against the plain version and against the plain parts merged in
    part order (``fwd_by_parts``), and bit for bit on a repeat."""
    layout = _sparse_layout(kind, 2, nb, block)
    luts = sparse_luts(layout, cuda)
    assert luts.fwd_slots > 0 and luts.fwd_merge.shape[0] > 0
    q, k, v, _ = flash_inputs(cuda, dtype, 2 * 2, nb * block, dh, seed=block)
    kw = dict(block=block, causal=causal)
    out, lse = block_sparse_fwd(q, k, v, luts, **kw)
    again = block_sparse_fwd(q, k, v, luts, **kw)
    ref, ref_lse = block_sparse_fwd_plain(q, k, v, luts, **kw)
    parts, parts_lse = fwd_by_parts(q, k, v, luts, part=64, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert rel_err(out, ref) <= SPARSE_TOL[dtype], rel_err(out, ref)
    assert rel_err(out, parts) <= SPARSE_TOL[dtype], rel_err(out, parts)
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    assert (lse - parts_lse).abs().max().item() <= 1e-4
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_sparse_fwd_replays_in_a_cuda_graph(cuda, dtype):
    """The forward and its merge (a programmatic dependent launch) captured
    in a CUDA graph: the replay writes the eager launch's bits."""
    layout = _sparse_layout("bigbird", 2, 80, 16)
    luts = sparse_luts(layout, cuda)
    assert luts.fwd_merge.shape[0] > 0
    q, k, v, _ = flash_inputs(cuda, dtype, 2 * 2, 80 * 16, 64, seed=3)
    kw = dict(block=16, causal=False)
    eager = block_sparse_fwd(q, k, v, luts, **kw)
    replay = graph_replay(lambda: block_sparse_fwd(q, k, v, luts, **kw))
    assert torch.equal(replay[0], eager[0]) and torch.equal(replay[1], eager[1])


# f32 dQ against an f64 run of the same arithmetic (as the CPU test of the
# same name in test_torch_sparse_attention.py)
F64_DQ_BOUND = 2e-5


@pytest.mark.parametrize("block,nb,dh,kind,causal,seed", [
    (64, 68, 128, "fixed", True, 192), (16, 160, 128, "fixed", True, 16),
    (16, 160, 64, "bigbird", False, 16), (32, 144, 64, "longformer", True, 32)])
def test_f32_dq_orders_against_f64(cuda, block, nb, dh, kind, causal, seed):
    """The f32 dQ kernel, its plain version and the part-wise sum of its
    work list (``dq_by_parts``) each within ``F64_DQ_BOUND`` of an f64 run of
    the plain arithmetic on the same lse and delta, B 2 x 2 heads; the
    first case is the long Fixed causal layout whose kernel reading sits
    past 1e-5 against the plain version. Prints each order's reading."""
    luts = sparse_luts(_sparse_layout(kind, 2, nb, block), cuda)
    q, k, v, do = flash_inputs(cuda, torch.float32, 2 * 2, nb * block, dh,
                               seed=seed)
    kw = dict(block=block, causal=causal)
    out, lse = block_sparse_fwd_plain(q, k, v, luts, **kw)
    delta = block_sparse_delta(do, out)
    ref64 = block_sparse_bwd_dq_plain(*(x.double() for x in (q, k, v, do)),
                                      lse, delta, luts, **kw)
    errs = {"kernel": block_sparse_bwd_dq(q, k, v, do, lse, delta, luts, **kw),
            "plain": block_sparse_bwd_dq_plain(q, k, v, do, lse, delta, luts,
                                               **kw),
            "parts": dq_by_parts(q, k, v, do, lse, delta, luts, part=64, **kw)}
    errs = {name: rel_err(x, ref64) for name, x in errs.items()}
    errs["kernel_vs_plain"] = rel_err(
        block_sparse_bwd_dq(q, k, v, do, lse, delta, luts, **kw),
        block_sparse_bwd_dq_plain(q, k, v, do, lse, delta, luts, **kw))
    print(f"f32 dQ against f64 at {kind} block {block} nb {nb} Dh {dh}: {errs}")
    for name in ("kernel", "plain", "parts"):
        assert errs[name] <= F64_DQ_BOUND, (name, errs)


def test_block_sparse_autograd_runs_the_kernels(cuda):
    h, block, t = 4, 16, 256
    layout = _sparse_layout("bigbird", h, t // block, block)
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, t, h, 64), generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    n = (block_sparse_fwd.launches, block_sparse_bwd_dq.launches,
         block_sparse_bwd_dkv.launches)
    out = block_sparse_attention(q, k, v, layout, block, True)
    out.float().square().sum().backward()
    assert (block_sparse_fwd.launches, block_sparse_bwd_dq.launches,
            block_sparse_bwd_dkv.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    ref = block_sparse_attention_reference(q, k, v, layout, block, True)
    assert rel_err(out, ref) <= SPARSE_TOL[torch.bfloat16]
    for x in (q, k, v):
        assert x.grad.shape == x.shape and torch.isfinite(x.grad.float()).all()


def test_block_sparse_wrappers_reject_bad_inputs(cuda):
    luts = sparse_luts(_sparse_layout("bigbird", 2, 8, 16), cuda)
    q, k, v, do = flash_inputs(cuda, torch.bfloat16, 4, 128, 64)
    n0 = (block_sparse_fwd.launches, block_sparse_bwd_dq.launches,
          block_sparse_bwd_dkv.launches)
    with pytest.raises(ValueError, match="block=8"):    # the CPU tests' block
        block_sparse_fwd(q, k, v, sparse_luts(_sparse_layout(
            "bigbird", 2, 16, 8), cuda), block=8, causal=False)
    with pytest.raises(ValueError, match="Dh=96"):
        block_sparse_fwd(*flash_inputs(cuda, torch.bfloat16, 4, 128, 96)[:3],
                         luts, block=16, causal=False)
    with pytest.raises(ValueError):                      # f64
        block_sparse_fwd(q.double(), k.double(), v.double(), luts, block=16,
                         causal=False)
    with pytest.raises(ValueError):                      # T != nb * block
        block_sparse_fwd(*flash_inputs(cuda, torch.bfloat16, 4, 144, 64)[:3],
                         luts, block=16, causal=False)
    with pytest.raises(ValueError):                      # tables on the CPU
        block_sparse_fwd(q, k, v, sparse_luts(_sparse_layout(
            "bigbird", 2, 8, 16), "cpu"), block=16, causal=False)
    out, lse = block_sparse_fwd_plain(q, k, v, luts, block=16, causal=False)
    delta = block_sparse_delta(do, out)
    with pytest.raises(ValueError):                      # non-contiguous dO
        block_sparse_bwd_dq(q, k, v, do.transpose(1, 2).contiguous()
                            .transpose(1, 2), lse, delta, luts, block=16,
                            causal=False)
    with pytest.raises(ValueError):                      # lse with a unit dim
        block_sparse_bwd_dkv(q, k, v, do, lse[..., None], delta, luts,
                             block=16, causal=False)
    assert (block_sparse_fwd.launches, block_sparse_bwd_dq.launches,
            block_sparse_bwd_dkv.launches) == n0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("n,d,e", [(1, 256, 512), (2, 384, 640),
                                   (8, 4096, 4096), (17, 384, 2048),
                                   (32, 1000, 11008)])
def test_gridded_int8_matmul_matches_plain(cuda, dtype, n, d, e):
    x, q, s = _mm_inputs(cuda, dtype, n, d, e, layers=1)
    q, s = q[0], s[0]                                    # s [1, E]
    out = int8_matmul(x, q, s)
    ref = int8_matmul_plain(x, q, s)
    err = (out.float() - ref.float()).abs()
    assert (err <= MATMUL_RTOL[dtype] * ref.float().abs() + 1e-3).all(), \
        err.max().item()
    assert torch.equal(int8_matmul(x, q, s), out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_gridded_int8_matmul_every_batch_width(cuda, dtype):
    """Every N from 1 to 32 (the 16-bit body's n-tiles: 1-8, 9-16, 17-24,
    25-32) at ragged D (384 and 1408: a block's walk ends on a short stage
    or none; 1001: 16-bit x copied into rows of 1008) and E (a last column
    tile cut short), at both column tiles (64 where E gives 80 or more
    such blocks: E 5136 and CodeLlama-34B's 8192 with the big ring, 11008
    without), against the plain version; each row's result is the same
    bits at every batch width (the plan depends on (D, E) alone) and on a
    repeat."""
    for d, e in ((384, 2064), (1408, 640), (1001, 656), (1001, 5136),
                 (8192, 8192), (384, 11008)):
        x, q, s = _mm_inputs(cuda, dtype, 32, d, e, layers=1, seed=d)
        q, s = q[0], s[0]
        full = int8_matmul(x, q, s)
        assert torch.equal(int8_matmul(x, q, s), full), (d, e)
        for n in range(1, 33):
            xn = x[:n].contiguous()
            out = int8_matmul(xn, q, s)
            ref = int8_matmul_plain(xn, q, s)
            err = (out.float() - ref.float()).abs()
            assert (err <= MATMUL_RTOL[dtype] * ref.float().abs() + 1e-3).all(), \
                (d, e, n, err.max().item())
            assert torch.equal(out, full[:n]), (d, e, n)


def test_gridded_int8_matmul_rejects_bad_inputs(cuda):
    x, q, s = _mm_inputs(cuda, torch.bfloat16, 33, 256, 512, layers=1)
    n0 = int8_matmul.launches
    with pytest.raises(ValueError):     # > 32 rows
        int8_matmul(x, q[0], s[0])
    with pytest.raises(ValueError):     # stacked weight: the DMA form's
        int8_matmul(x[:4].contiguous(), q, s)
    with pytest.raises(ValueError):     # E % 16
        int8_matmul(x[:4].contiguous(), q[0, :, :504].contiguous(),
                    s[0, :, :504].contiguous())
    with pytest.raises(TypeError):      # bf16 scales
        int8_matmul(x[:4].contiguous(), q[0], s[0].to(torch.bfloat16))
    assert int8_matmul.launches == n0


# ------------------------------------------------- data efficiency (PR 18)
def test_flash_kernels_at_the_ltd_shape(cuda):
    """GPT-2 774M's random-LTD middle layers: B·H 8·20, T_keep 512, Dh 64,
    bf16, causal; held row by row, the backward bit for bit on a repeat."""
    q, k, v, do = flash_inputs(cuda, torch.bfloat16, 8 * 20, 512, 64, seed=18)
    out, lse = flash_fwd_parts(q, k, v, causal=True)
    ref, ref_lse = flash_fwd_parts_plain(q, k, v, causal=True)
    assert rel_err(out, ref) <= FLASH_TOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    delta = flash_delta(do, ref)
    grads = (flash_bwd_dq(q, k, v, do, ref_lse, delta, causal=True),
             *flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal=True))
    again = (flash_bwd_dq(q, k, v, do, ref_lse, delta, causal=True),
             *flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal=True))
    plain = (flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal=True),
             *flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, causal=True))
    torch.cuda.synchronize()
    for got, rep_, want in zip(grads, again, plain):
        assert torch.isfinite(got.float()).all()
        assert rel_err(got, want) <= FLASH_TOL[torch.bfloat16]
        assert torch.equal(got, rep_)


def _small_gpt2(layers=4):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    return GPT2Model(GPT2Config(vocab_size=512, max_seq_len=128,
                                num_layers=layers, hidden_size=128,
                                num_heads=2), attn_impl="flash")


@pytest.mark.parametrize("option", ["ltd", "pld"])
def test_data_efficiency_training_launches_the_kernels(cuda, option):
    """A small GPT-2 (4 layers, 2 heads of Dh 64, bf16) through initialize()
    on the card: random-LTD keeping 24 of 64 tokens runs the two outer
    layers' kernels at T 64 and the middle ones' at T 24 (the kernels'
    reported work pins the split); PLD launches every block's kernels."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernel_flops import attn_pairs, kernel_flops_counter

    extra = ({"data_efficiency": {"data_routing": {"random_ltd": {
        "enabled": True, "random_ltd_schedule": {"min_value": 24,
                                                 "max_value": 24}}}}}
             if option == "ltd" else
             {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                         "gamma": 1.0}})
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=_small_gpt2(), config={"train_batch_size": 4,
                                     "gradient_accumulation_steps": 2,
                                     "bf16": {"enabled": True},
                                     "steps_per_print": 0, **extra})
    ids = np.random.RandomState(0).randint(0, 512, (2, 2, 65))
    batch = {"input_ids": ids[..., :-1], "labels": ids[..., 1:]}
    n0 = flash_fwd_parts.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches
    with kernel_flops_counter() as kc:
        losses = [float(eng.train_batch_from_stacked(batch)) for _ in range(2)]
    n = (flash_fwd_parts.launches - n0[0], flash_bwd_dq.launches - n0[1],
         flash_bwd_dkv.launches - n0[2])
    assert n == (16, 16, 16) and all(np.isfinite(losses))
    per = 2 * 2 * (2 * 2) * 64       # 2 products of 2 FLOPs, B 2 x H 2, Dh 64
    lengths = (64, 24, 24, 64) if option == "ltd" else (64,) * 4
    assert kc.kernels["flash_fwd_parts"] == 4 * per * sum(
        attn_pairs(t, t, True) for t in lengths)
    eng.destroy()


def test_flops_profiler_counts_the_same_on_the_card_and_the_cpu(cuda):
    """One forward (get_model_profile) and one forward + backward
    (count_flops) of a small GPT-2 with the flash kernels: the card's totals
    and kernel reports equal the CPU's (plain versions) exactly."""
    import numpy as np

    from deepspeed_tpu_torch.profiling import count_flops, get_model_profile
    from deepspeed_tpu_torch.utils.tree import tree_map

    model = _small_gpt2(2)
    params = model.init(torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    ids = np.random.RandomState(1).randint(0, 512, (2, 96))
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", cuda)):
        p = tree_map(lambda x: x.to(dev), params)
        batch = {k: torch.as_tensor(ids).long().to(dev)
                 for k in ("input_ids", "labels")}
        fwd = get_model_profile(model, batch, params=p, as_string=False)
        leaves = tree_map(lambda x: x.to(torch.bfloat16).requires_grad_(), p)
        step = count_flops(lambda: model.apply(leaves, batch)[0].backward())
        out[name] = (fwd, step["flops"], step["kernel_flops"])
    assert out["card"] == out["cpu"], out
