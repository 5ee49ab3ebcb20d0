"""The async IO engine and the swap subsystem of the port (deepspeed_tpu_torch/
ops/aio.py over csrc/aio/dstpu_aio.cpp, runtime/swap_tensor/) against the
JAX package's, on the CPU.

The port's counterparts of tests/unit/ops/test_aio.py, on torch CPU
tensors: round trips, offset reads, wait_all over parallel files, errors,
the engine's settings, the tensor swapper, the parameter swapper's
residency states and buffer pool, and the optimizer swapper, plain and
pipelined. Files cross the packages: what one engine writes, the other
reads back byte for byte. Every comparison is exact (bytes moved, no
arithmetic).
"""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.runtime.swap_tensor import (
    AsyncPartitionedParameterSwapper, AsyncTensorSwapper, OptimizerSwapper,
    PartitionedParamStatus, PipelinedOptimizerSwapper, SwapBufferPool)
from deepspeed_tpu_torch.runtime.swap_tensor.buffer_pool import ALIGNMENT, aligned_empty

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _reference_build_dir():
    """The reference's native build lands under the repo's build/."""
    old = os.environ.get("DSTPU_BUILD_DIR")
    os.environ["DSTPU_BUILD_DIR"] = os.path.join(ROOT, "build", "native_reference")
    yield
    if old is None:
        os.environ.pop("DSTPU_BUILD_DIR", None)
    else:
        os.environ["DSTPU_BUILD_DIR"] = old


@pytest.fixture
def handle():
    return AsyncIOHandle(block_size=1 << 16, num_threads=4)


def _randn(n, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(n).astype(np.float32))


# ---------------------------------------------------------------- the engine
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_round_trip(handle, tmp_path, mode):
    # a size that is not a multiple of the block size
    src = _randn(100_000) if mode == "sync" else torch.arange(257_123)
    f = str(tmp_path / "t.bin")
    dst = torch.empty_like(src)
    if mode == "sync":
        handle.sync_pwrite(src, f)
        handle.sync_pread(dst, f)
    else:
        assert handle.wait(handle.async_pwrite(src, f)) == 0
        assert handle.wait(handle.async_pread(dst, f)) == 0
    assert torch.equal(src, dst)
    assert os.path.getsize(f) == src.numel() * src.element_size()


def test_offset_read_and_bf16_bytes(handle, tmp_path):
    src = torch.arange(10_000, dtype=torch.float64)
    f = str(tmp_path / "t.bin")
    handle.sync_pwrite(src, f)
    part = torch.empty(100, dtype=torch.float64)
    handle.sync_pread(part, f, offset=8 * 500)
    assert torch.equal(part, src[500:600])
    img = _randn(4096, 1).to(torch.bfloat16)
    handle.sync_pwrite(img, f)
    back = torch.empty_like(img)
    handle.sync_pread(back, f)
    assert torch.equal(back.view(torch.int16), img.view(torch.int16))


def test_parallel_files_wait_all(handle, tmp_path):
    srcs = [_randn(50_000, i) for i in range(6)]
    for i, s in enumerate(srcs):
        handle.async_pwrite(s, str(tmp_path / f"m{i}.bin"))
    assert handle.wait() == 6
    for i, s in enumerate(srcs):
        d = torch.empty_like(s)
        handle.sync_pread(d, str(tmp_path / f"m{i}.bin"))
        assert torch.equal(s, d)


def test_errors_and_settings(handle, tmp_path):
    with pytest.raises(OSError):
        handle.sync_pread(torch.empty(10), str(tmp_path / "nope.bin"))
    with pytest.raises(AssertionError, match="contiguous"):
        handle.sync_pwrite(torch.empty(4, 4).t(), str(tmp_path / "x.bin"))
    assert handle.get_block_size() == 1 << 16
    assert handle.get_thread_count() == 4
    assert handle.get_queue_depth() == 32


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_cross_the_packages(tmp_path, writer):
    from deepspeed_tpu.ops.aio import AsyncIOHandle as JHandle

    jh, th = JHandle(block_size=1 << 16, num_threads=4), AsyncIOHandle(
        block_size=1 << 16, num_threads=4)
    src = np.random.RandomState(7).randn(70_001).astype(np.float32)
    f = str(tmp_path / "x.bin")
    if writer == "port":
        th.sync_pwrite(torch.from_numpy(src), f)
        back = np.empty_like(src)
        jh.sync_pread(back, f)
        np.testing.assert_array_equal(back, src)
    else:
        jh.sync_pwrite(src, f)
        back = torch.empty(src.size)
        th.sync_pread(back, f, offset=0)
        np.testing.assert_array_equal(back.numpy(), src)


# ----------------------------------------------------------- the swappers
def test_tensor_swapper_sync_and_async(tmp_path):
    sw = AsyncTensorSwapper(str(tmp_path))
    x = _randn(3 * 77, 1).view(3, 77)
    sw.swap_out("layer/weight", x, async_op=False)
    y = sw.swap_in("layer/weight", async_op=False)
    assert y.shape == x.shape and torch.equal(x, y)
    z = torch.arange(1000, dtype=torch.int32)
    sw.swap_out("a", z, async_op=True)
    sw.synchronize()
    sw.swap_in("a", async_op=True)
    assert torch.equal(sw.wait_in("a"), z)
    assert sw.meta("a") == ((1000,), torch.int32)
    assert sw.bytes_written == sw.bytes_read == x.numel() * 4 + 4000
    sw.release("a")
    assert not sw.contains("a")


def test_buffer_pool_alignment_and_reuse():
    buf = aligned_empty(4 * 1000, torch.float32)
    assert buf.data_ptr() % ALIGNMENT == 0 and buf.numel() == 1000
    pool = SwapBufferPool(1 << 12, 2)
    a, b = pool.get(100), pool.get(4096)
    assert pool.get(10) is None and pool.available() == 0
    assert pool.get(1 << 13) is None                  # larger than a buffer
    ptr = a.data_ptr()
    pool.put(a.view(torch.float32))
    assert pool.get(64).data_ptr() == ptr             # the same buffer again
    pool.put(b)
    assert pool.available() == 1


def test_parameter_swapper_residency(tmp_path):
    sw = AsyncPartitionedParameterSwapper(str(tmp_path), buffer_count=2,
                                          buffer_size=1 << 20)
    shards = {f"p{i}": _randn(128, i) for i in range(4)}
    for n, s in shards.items():
        sw.swap_out_and_release(n, s, async_op=False)
        assert sw.status[n] == PartitionedParamStatus.NOT_AVAILABLE
    sw.swap_in(["p0", "p1"], async_op=True)
    assert sw.status["p0"] == PartitionedParamStatus.INFLIGHT
    sw.synchronize_reads()
    assert sw.status["p0"] == PartitionedParamStatus.AVAILABLE
    assert torch.equal(sw.get("p0"), shards["p0"])
    assert torch.equal(sw.get("p1"), shards["p1"])
    assert sw.available_swap_in_buffers() == 0
    sw.release("p0")                          # buffers go back to the pool
    sw.release("p1")
    sw.swap_in(["p2", "p3"], async_op=False)
    assert torch.equal(sw.get("p3"), shards["p3"])
    sw.remove("p3")
    assert "p3" not in sw.status


def test_parameter_swapper_recycles_and_falls_back(tmp_path):
    sw = AsyncPartitionedParameterSwapper(str(tmp_path), buffer_count=2,
                                          buffer_size=1 << 16)
    x = torch.arange(64, dtype=torch.float32)
    sw.swap_out_and_release("p", x, async_op=False)
    for _ in range(5):        # cycles must not drain the pool
        sw.swap_in(["p"], async_op=False)
        assert torch.equal(sw.get("p"), x)
        sw.swap_out_and_release("p", sw.get("p").clone(), async_op=True)
        sw.swap_in(["p"], async_op=False)
        sw.synchronize_writes()
    sw.release("p")
    assert sw.pool.available() == 2
    big = _randn(1024)                  # larger than a pool buffer
    small = AsyncPartitionedParameterSwapper(str(tmp_path / "s"),
                                             buffer_count=1, buffer_size=16)
    small.swap_out_and_release("big", big, async_op=False)
    small.swap_in(["big"], async_op=False)
    assert torch.equal(small.get("big"), big)


def test_optimizer_swapper_round_trip_and_reference_files(tmp_path):
    from deepspeed_tpu.runtime.swap_tensor import OptimizerSwapper as JSwapper

    state = {"master": torch.ones(64), "m": _randn(64, 2), "v": torch.zeros(64)}
    sw = OptimizerSwapper(str(tmp_path))
    sw.swap_out_group(0, state)
    back = sw.swap_in_group(0, list(state))
    for k in state:
        assert torch.equal(back[k], state[k])
    # the reference reads the port's files under the same names
    js = JSwapper(str(tmp_path))
    for k, v in state.items():
        js.swapper._meta[js._key(0, k)] = ((64,), np.float32)
    jback = js.swap_in_group(0, list(state))
    for k in state:
        np.testing.assert_array_equal(jback[k], state[k].numpy())


@pytest.mark.parametrize("groups", [1, 5])
def test_pipelined_step_matches_the_plain_one(tmp_path, groups):
    names = ["master", "m"]

    def step_fn(seen):
        def fn(g, state):
            assert state["master"][0] == float(g)
            state["master"].add_(1.0).mul_(1.5)
            state["m"].add_(state["master"] * 0.5)
            seen.append(g)
        return fn

    plain, piped = OptimizerSwapper(str(tmp_path / "a")), \
        PipelinedOptimizerSwapper(str(tmp_path / "b"))
    for sw in (plain, piped):
        for g in range(groups):
            sw.swap_out_group(g, {"master": torch.full((33,), float(g)),
                                  "m": _randn(33, g)})
    seen_plain, seen_piped = [], []
    for g in range(groups):                   # the plain loop: in, step, out
        state = plain.swap_in_group(g, names)
        step_fn(seen_plain)(g, state)
        plain.swap_out_group(g, state)
    piped.run_step(list(range(groups)), names, step_fn(seen_piped))
    assert seen_plain == seen_piped == list(range(groups))
    for g in range(groups):
        a, b = plain.swap_in_group(g, names), piped.swap_in_group(g, names)
        for k in names:
            assert torch.equal(a[k], b[k])
        assert b["master"][0] == pytest.approx((g + 1.0) * 1.5)
