"""Parity of the port's block-paged KV store with the JAX package's: the
quantizer (serving/kv_quant), the block-table write and gather
(ops/attention), the block pool and the radix prefix cache
(serving/kv_blocks, serving/radix), and the pool bridge
(inference/weights.kv_pool_from_numpy).

Inputs come from numpy seeds and go to both packages. Everything here must
agree exactly: quantized payloads and scales bit for bit, written and
gathered pools bit for bit, and the host bookkeeping (tables, free lists,
refcounts, hit/miss/copy-on-write/eviction counters) value for value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JLlamaModel
from deepspeed_tpu.ops import attention as jattn
from deepspeed_tpu.serving import BlockKVPool as JBlockKVPool
from deepspeed_tpu.serving import PrefixCache as JPrefixCache
from deepspeed_tpu.serving import kv_quant as jkvq
from deepspeed_tpu_torch.inference.weights import kv_pool_from_numpy
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.serving import BlockKVPool, PrefixCache
from deepspeed_tpu_torch.serving.kv_quant import kv_quantize

BS = 16


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a tensor as unsigned integers."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(view).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_kv_quantize_bit_identical_to_jax(kv_dtype):
    """Random rows at several magnitudes, a zero row, and (fp8) a row whose
    amax / 448 rounds DOWN to its bf16 scale, so |x / s| reaches 448.875:
    past 448, under the 464 where the JAX cast turns to NaN and torch's
    saturates. Both casts give the same byte there."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4, 64).astype(np.float32)
    x *= np.exp(rng.uniform(-6, 6, size=(64, 4, 1))).astype(np.float32)
    x[0, 0] = 0.0
    edge = np.float32(448.0 * (1 + 2 ** -9))      # bf16(edge/448) == 1.0
    x[1, 0, :] = rng.uniform(-1, 1, 64)
    x[1, 0, 7] = edge
    x[1, 1, :] = -x[1, 0, :]
    jq, js = jkvq.kv_quantize(jnp.asarray(x), kv_dtype)
    tq, ts = kv_quantize(torch.from_numpy(x), kv_dtype)
    assert np.array_equal(_bits(tq), _jbits(jq))
    assert np.array_equal(_bits(ts), _jbits(js))
    if kv_dtype == "fp8":
        y = x[1, 0, 7] / ts[1, 0].float().item()
        assert 448.0 < y < 449.75
        assert tq[1, 0, 7].float().item() == 448.0
        assert tq[1, 1, 7].float().item() == -448.0
        assert np.isfinite(np.asarray(jq, np.float32)).all()


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_write_and_gather_blocks_match_jax(kv_dtype):
    """A 3-token write per row through a permuted table, rows straddling
    block edges, then a write that runs past the table width (overflow to
    the garbage row); the written pools and the gathered slot views agree
    bit for bit."""
    rng = np.random.RandomState(2)
    l, b, hkv, dh, mb, t = 2, 3, 2, 16, 3, 3
    n_phys = b * mb + 1
    table = rng.permutation(b * mb).reshape(b, mb).astype(np.int32)
    base = rng.randn(l, n_phys, hkv, BS, dh).astype(np.float32)
    if kv_dtype is None:
        jk = jv = jnp.asarray(base)
        tk, tv = torch.from_numpy(base.copy()), torch.from_numpy(base.copy())
    else:
        jk = jv = jkvq.quantized_pool_like(jnp.asarray(base), dh, kv_dtype)
        tk, tv = (kv_pool_from_numpy(jax.device_get(jk), dh, "cpu")
                  for _ in range(2))
    for idx in ([0, 14, 31], [mb * BS - 1] * b):
        kn = rng.randn(b, t, hkv, dh).astype(np.float32)
        vn = rng.randn(b, t, hkv, dh).astype(np.float32)
        jk, jv = jattn.write_kv_blocks(jk, jv, jnp.asarray(kn),
                                       jnp.asarray(vn), 1,
                                       jnp.asarray(idx, jnp.int32),
                                       jnp.asarray(table))
        tattn.write_kv_blocks(tk, tv, torch.from_numpy(kn),
                              torch.from_numpy(vn), 1,
                              torch.tensor(idx, dtype=torch.int32),
                              torch.from_numpy(table))
        for tp, jp in ((tk, jk), (tv, jv)):
            want = kv_pool_from_numpy(jax.device_get(jp), dh, "cpu")
            if kv_dtype is None:
                # the garbage row takes 2 overflow writes from each of 3
                # rows at once: which lands last is unspecified
                assert torch.equal(tp[:, :-1], want[:, :-1])
            else:
                for key in ("q", "s"):
                    assert np.array_equal(_bits(tp[key][:, :-1]),
                                          _bits(want[key][:, :-1]))
    jl = jax.tree_util.tree_map(lambda a: a[1], jk)
    want = np.asarray(jattn.gather_block_kv(
        jl, jnp.asarray(table), None if kv_dtype is None else jnp.float32))
    got = tattn.gather_block_kv(tattn.pool_layer(tk, 1),
                                torch.from_numpy(table),
                                None if kv_dtype is None else torch.float32)
    assert got.shape == (b, hkv, mb * BS, dh)
    assert np.array_equal(got.numpy(), want)


def _run_script(pool, pc):
    """One admit/finish/fork/evict script; the state after every step."""
    log = []

    def snap(what, ret=None):
        log.append((what, ret, pool.tables.tolist(), list(pool._free),
                    pool.ref.tolist(), pc.hit_tokens, pc.miss_tokens,
                    pc.blocks_cowed, pc.blocks_evicted, pc.cached_blocks(),
                    pc.evictable_count(), pool.occupancy(), pc.hit_rate()))

    base = list(range(48))
    snap("admit cold", pc.admit(0, list(range(40)), 44))
    pc.finish(0)
    snap("finish: donate 2 blocks")
    snap("admit shared", pc.admit(1, list(range(40)), 44))
    pc.finish(1)
    snap("finish: dedup")
    snap("admit 3 blocks", pc.admit(0, base, 52))
    pc.finish(0)
    snap("finish")
    snap("admit fork", pc.admit(1, base[:40] + [999] * 8, 52))
    foreign = list(range(500, 532))
    snap("fits foreign", (pc.fits(foreign, 64), pc.fits(foreign, 200)))
    snap("admit foreign", pc.admit(2, foreign, 60))
    pc.finish(2)
    snap("finish foreign")
    pc._evict_lru(pool.free_count + 2)
    snap("evict 2")
    pc.finish(1)
    snap("finish fork")
    snap("fits full", pc.fits(list(range(900, 964)), 64))
    pc._evict_lru(pool.num_blocks)
    snap("evict all")
    return log


def test_pool_and_prefix_cache_bookkeeping_match_jax():
    jpool = JBlockKVPool(JLlamaModel(JLlamaConfig.tiny()), 3, 64,
                         block_size=BS, num_blocks=16)
    tpool = BlockKVPool(LlamaModel(LlamaConfig.tiny()), 3, 64, block_size=BS,
                        num_blocks=16, dtype=torch.float32, device="cpu")
    want = _run_script(jpool, JPrefixCache(jpool))
    got = _run_script(tpool, PrefixCache(tpool))
    assert [w[0] for w in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    assert got[-1][8] > 0 and got[7][7] == 1     # evictions and a fork ran


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_pool_sizes_and_bridge_round_trip(kv_dtype):
    """The port's pool has the JAX pool's logical shape and bytes, and a
    JAX pool (packed, pair-grouped scales) bridged into the port gathers the
    same slot view as the JAX gather."""
    jpool = JBlockKVPool(JLlamaModel(JLlamaConfig.tiny()), 2, 64,
                         block_size=BS, num_blocks=8, dtype=jnp.float32,
                         kv_dtype=kv_dtype)
    tpool = BlockKVPool(LlamaModel(LlamaConfig.tiny()), 2, 64, block_size=BS,
                        num_blocks=8, dtype=torch.float32, kv_dtype=kv_dtype,
                        device="cpu")
    assert tpool.hbm_bytes() == jpool.hbm_bytes()
    assert tpool.blocks_per_mib() == pytest.approx(jpool.blocks_per_mib())
    dh = LlamaConfig.tiny().head_dim
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(*jpool.k["q"].shape if kv_dtype
                              else jpool.k.shape), jnp.float32)
    if kv_dtype is None:
        jp = x.astype(jpool.k.dtype)
    else:
        unpacked = x.reshape(tpool.k["q"].shape[:4] + (dh,))
        q, s = jkvq.kv_quantize(unpacked, kv_dtype)
        pair = jpool.pair
        jp = {"q": q.reshape(jpool.k["q"].shape),
              "s": jnp.moveaxis(s.reshape(s.shape[:-1] + (BS // pair, pair)),
                                -1, -2)}
    tp = kv_pool_from_numpy(jax.device_get(jp), dh, "cpu")
    table = rng.permutation(8).reshape(2, 4).astype(np.int32)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp)
    if jpool.pair > 1 and kv_dtype is None:
        jl = jl.reshape(tpool.k.shape[1:])
    elif jpool.pair > 1:
        jl = {"q": jl["q"].reshape(tpool.k["q"].shape[1:]), "s": jl["s"]}
    want = np.asarray(jattn.gather_block_kv(jl, jnp.asarray(table),
                                            jnp.float32))
    got = tattn.gather_block_kv(tattn.pool_layer(tp, 1),
                                torch.from_numpy(table), torch.float32)
    assert np.array_equal(got.numpy(), want)
