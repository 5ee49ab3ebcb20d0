"""On-card smoke run of the PyTorch port (deepspeed_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device    — nvidia-smi's name and power limit; builds the CUDA kernels
               from deepspeed_tpu_torch/csrc (nvcc, sm_90a) and times it.
2. kernels   — each hand-written kernel against its plain PyTorch version on
               the card at the serving path's full LLaMA-7B shapes (fused
               decode step: 8 slots x 32 heads x Dh 128 x S 1024, per-slot
               lengths incl. 0, S-1 and S, plus a GQA rep-4 case; block
               decode step: the same slots over a pool of 16-token blocks
               through a permuted 64-wide table, lengths incl. 0, 15, 16,
               1023 and an inactive slot on a sentinel table, pools in bf16,
               int8 and fp8, plus GQA rep 4; int8 matmul: the three block
               shapes at N in {1, 8, 32}, stacked, last layer). Written
               cache bytes must be bit-identical (block pools: every row but
               the garbage row). Times are device times: 20 launches on
               inputs rotated through more than the 50 MB L2 are captured in
               a CUDA graph, whose replay is timed with CUDA events (median
               of 20).
3. reference — a small LLaMA served by the port on the CPU (plain versions)
               and on the card (kernels), fp32 with and without int8 block
               weights: identical greedy tokens. Then block-paged with a
               prefix cache on a shared-prefix trace (templates of 41
               tokens, so hits fork a block), cold and warm, with the pool in
               fp32, int8 and fp8: CPU and card tokens identical, fp32 pool
               tokens identical to slot-paged serving.
4. serve_bf16 / 5. serve_int8 — LLaMA-7B at full width and depth (random
               weights from a seeded torch.Generator) behind ServingEngine
               (8 slots, max_len 1024, buckets 128/512), 12 requests from a
               seeded trace. Every request finishes with its full token
               count; the launch counters, zeroed just before the run, equal
               32 x decode_steps (fused decode) and 7 x 32 x decode_steps
               (int8 matmul, int8 only); one request re-served alone gives
               bit-identical tokens; the probe's logits, recomputed by a
               plain no-cache forward and by a cached replay through the
               kernels, agree, and agree with its served tokens on
               margin-safe steps; a profile of five decode steps, with
               every slot holding a live request, gives the device's busy
               share and its top kernels.
   serve_block_bf16 / serve_block_kv_int8 — phase 4's bf16 engine behind a
               block-paged ServingEngine with a prefix cache (16-token
               blocks; pool in bf16, then int8), 16 requests over 2 shared
               392-token templates, served cold and then warm. Launches: 32
               x decode_steps of the block decode step and none of the slot
               one; the warm run prefills at most 0.4 x the cold run's
               tokens; forks taken; the probe check on the longest request,
               replayed through the same pool type; the decode profile,
               its slots on real block tables.
6. probe_fp32 — LLaMA-7B in fp32: the trace's longest request served alone,
               its kernel-cached replay held to the no-cache forward within
               1e-3 of max |logit|, and its served tokens to the replay.
               Then block-paged: template + suffix A served cold, then the
               probe, template + suffix B, warm (a suffix-only prefill over
               shared blocks plus a fork), held the same way.

The line before the last is the kernels summary; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.ops import cuda_build
from deepspeed_tpu_torch.ops.attention import gather_block_kv, pool_layer
from deepspeed_tpu_torch.ops.decode_step import (fused_block_decode_step,
                                                 fused_block_decode_step_plain,
                                                 fused_decode_step,
                                                 fused_decode_step_plain)
from deepspeed_tpu_torch.ops.int8_matmul import (int8_matmul_dma,
                                                 int8_matmul_plain)
from deepspeed_tpu_torch.ops.kernel_check import (block_step_inputs,
                                                  clone_pool, random_pool,
                                                  real_rows_equal)
from deepspeed_tpu_torch.serving import (BlockKVPool, Request, ServingEngine,
                                         poisson_trace, shared_prefix_trace)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
L2_BYTES = 50 * 2 ** 20
DECODE_TOL = 2e-2             # bf16 attention outputs, |kernel - plain|
MATMUL_RTOL = 8e-3            # one bf16 ulp of |out|, plus 1e-3 absolute
# LLaMA-7B probe logits, kernel-cached replay vs plain no-cache forward, as
# a share of max |logit|. fp32: the two differ only in summation order.
# bf16/int8: the no-cache forward rounds attention logits to bf16 where the
# decode kernel keeps them in f32 (ROADMAP queue 3 item 2), and 32 random
# layers amplify that; the bound only catches a gross error (a wrong
# position or head moves logits by their own size).
LOGIT_TOL = {"fp32": 1e-3, "bf16": 0.15, "int8": 0.15}
KERNELS = {
    "fused_decode_step": {
        "source": "deepspeed_tpu_torch/csrc/decode_step.cu",
        "replaces": "deepspeed_tpu/ops/decode_step.py:170 (_kernel)"},
    "int8_matmul_dma": {
        "source": "deepspeed_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "deepspeed_tpu/ops/int8_matmul.py:151 (_dma_kernel)"},
    "fused_block_decode_step": {
        "source": "deepspeed_tpu_torch/csrc/block_decode_step.cu",
        "replaces": "deepspeed_tpu/ops/decode_step.py:473 (_block_kernel)"},
}
WRAPPERS = {"fused_decode_step": fused_decode_step,
            "int8_matmul_dma": int8_matmul_dma,
            "fused_block_decode_step": fused_block_decode_step}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def time_ms(fn, n_inputs: int, per: int = 20, reps: int = 20) -> float:
    """Device time of one fn(i) call: ``per`` calls, ``i`` rotating through
    ``n_inputs`` input sets, are captured into one CUDA graph (so the
    host's launch cost, which exceeds a short kernel's run, is not timed),
    the graph is replayed ``reps`` times between CUDA events, and the
    median replay time is divided by ``per``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up off the capture
        for i in range(3):
            fn(i % n_inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per):
            fn(i % n_inputs)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    del graph
    return float(np.median(times))


# --------------------------------------------------------------- phase 1
def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_path = cuda_build.build(verbose=True)
    cuda_build.kernels()
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "library": str(lib_path.name),
            "build_s": time.perf_counter() - t0,
            "nvcc_build_s": cuda_build.build_seconds}
    emit(info)
    return info


# --------------------------------------------------------------- phase 2
def check_decode_step(b, hq, hkv, s, dh, idx, layers=2, seed=0):
    """Kernel vs plain at one geometry. Returns the row for the report."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    layer = layers - 1
    q, kn, vn = rnd(b, 1, hq, dh), rnd(b, 1, hkv, dh), rnd(b, 1, hkv, dh)
    kf, vf = rnd(layers, b, hkv, s, dh), rnd(layers, b, hkv, s, dh)
    iv = torch.tensor(idx, dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = kf.clone(), vf.clone(), kf.clone(), vf.clone()
    out, _, _ = fused_decode_step(q, k1, v1, kn, vn, layer, iv)
    ref, _, _ = fused_decode_step_plain(q, k2, v2, kn, vn, layer, iv)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(v1, v2), "cache bytes differ"
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= DECODE_TOL, f"fused_decode_step max err {err}"
    # scalar idx form on the same inputs
    outs, _, _ = fused_decode_step(q, k1.clone(), v1.clone(), kn, vn, layer,
                                   int(idx[1]))
    refs, _, _ = fused_decode_step_plain(q, k2.clone(), v2.clone(), kn, vn,
                                         layer, int(idx[1]))
    err = max(err, (outs.float() - refs.float()).abs().max().item())
    assert err <= DECODE_TOL, f"fused_decode_step (scalar idx) max err {err}"

    # timing: rotate over the layers (> L2 per call at these shapes)
    kernel_ms = time_ms(lambda i: fused_decode_step(q, kf, vf, kn, vn, i, iv),
                        layers)
    plain_ms = time_ms(
        lambda i: fused_decode_step_plain(q, kf, vf, kn, vn, i, iv), layers)
    rep = hq // hkv
    n_pos = [min(int(x), s - 1) + 1 for x in idx]
    mask = (torch.arange(s, device=dev)[None, :]
            < torch.tensor(n_pos, device=dev)[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)                      # [B, Hq, 1, Dh]

    gqa = {"enable_gqa": True} if rep > 1 else {}

    def sdpa(i):
        return torch.nn.functional.scaled_dot_product_attention(
            qs, kf[i], vf[i], attn_mask=mask, **gqa)

    library_ms = time_ms(sdpa, layers)
    esz = 2
    n_written = sum(1 for x in idx if 0 <= int(x) < s)
    nbytes = (b * hq * dh * esz * 2                      # q in, attn out
              + 2 * b * hkv * dh * esz                   # k_new, v_new in
              + 2 * n_written * hkv * dh * esz           # the cache writes
              + 2 * hkv * dh * esz * sum(n_pos))         # K, V prefix reads
    flops = 4 * hq * dh * sum(n_pos)                     # QK^T and P.V
    return {"b": b, "hq": hq, "hkv": hkv, "s": s, "dh": dh, "idx": list(idx),
            "max_abs_err": err, "tol": DECODE_TOL,
            "cache_bit_identical": True, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention (attention only)",
            "bytes": nbytes, "flops": flops,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  flops / BF16_FLOP_PER_S),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / BF16_FLOP_PER_S else "operations")}


def check_int8_matmul(n, d, e, seed=0):
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    # enough stacked layers that one rotation exceeds L2 (fresh weights)
    layers = max(2, math.ceil(3 * L2_BYTES / (d * e)))
    q = torch.randint(-128, 128, (layers, d, e), generator=g, device=dev,
                      dtype=torch.int8)
    s = (torch.rand((layers, 1, e), generator=g, device=dev) * 0.02)
    x = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
    out = int8_matmul_dma(x, q, s, layers - 1)
    ref = int8_matmul_plain(x, q, s, layers - 1)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    bound = MATMUL_RTOL * ref.float().abs() + 1e-3
    assert torch.isfinite(out.float()).all()
    assert (err <= bound).all(), f"int8_matmul_dma {n}x{d}x{e} err {err.max()}"
    kernel_ms = time_ms(lambda i: int8_matmul_dma(x, q, s, i), layers)
    plain_ms = time_ms(lambda i: int8_matmul_plain(x, q, s, i), layers)
    # yardstick only: PyTorch's weight-only int8 matmul takes the weight as
    # [E, D] and bf16 scales, so it gets its own copies of the same values
    qt = q.transpose(1, 2).contiguous()                 # [L, E, D]
    sb = s.reshape(layers, e).to(torch.bfloat16).contiguous()
    library_ms = time_ms(
        lambda i: torch._weight_int8pack_mm(x, qt[i], sb[i]), layers)
    del qt, sb
    nbytes = d * e + n * d * 2 + e * 4 + n * e * 2
    flops = 2 * n * d * e
    return {"n": n, "d": d, "e": e, "max_abs_err": err.max().item(),
            "tol": f"rtol {MATMUL_RTOL} + atol 1e-3",
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "torch._weight_int8pack_mm",
            "bytes": nbytes,
            "flops": flops,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  flops / BF16_FLOP_PER_S),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / BF16_FLOP_PER_S else "operations")}


def _bytes_bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_block_decode_step(b, hq, hkv, dh, bs, mb, kv, idx, seed=0):
    """Block decode kernel vs plain at one geometry and pool type: slot i
    names pool blocks perm[i*mb:(i+1)*mb] of a permuted pool, the last slot
    is inactive on a sentinel table (the garbage row). Checked on L = 2
    layers at layer 1; timed on ``n_t`` stacked layers so that one rotation
    reads more than the L2 holds."""
    dev = "cuda"
    nblk = (b - 1) * mb
    itemsize = 1 if kv else 2
    n_pos = [min(int(x), mb * bs - 1) + 1 for x in idx]
    read = 2 * sum(n_pos) * hkv * dh * itemsize + (
        2 * sum(n_pos) * hkv * 2 if kv else 0)
    n_t = max(2, math.ceil(3 * L2_BYTES / read))
    g, q, kp, vp, kn, vn, table = block_step_inputs(
        dev, torch.bfloat16, kv, b, hq, hkv, nblk, bs, mb, dh, seed=seed)
    iv = torch.tensor(idx, dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = (clone_pool(kp), clone_pool(vp), clone_pool(kp),
                      clone_pool(vp))
    out, _, _ = fused_block_decode_step(q, k1, v1, kn, vn, 1, iv, table)
    ref, _, _ = fused_block_decode_step_plain(q, k2, v2, kn, vn, 1, iv, table)
    torch.cuda.synchronize()
    assert real_rows_equal(k1, k2) and real_rows_equal(v1, v2), \
        f"block pool bytes differ (kv {kv})"
    assert not real_rows_equal(k1, kp), "the block writes did not land"
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= DECODE_TOL, f"fused_block_decode_step kv {kv} max err {err}"
    del kp, vp, k1, v1, k2, v2

    kt, vt = (random_pool(g, n_t, nblk, hkv, bs, dh, torch.bfloat16, kv)
              for _ in range(2))
    kernel_ms = time_ms(
        lambda i: fused_block_decode_step(q, kt, vt, kn, vn, i, iv, table), n_t)
    plain_ms = time_ms(
        lambda i: fused_block_decode_step_plain(q, kt, vt, kn, vn, i, iv,
                                                table), n_t)
    # yardstick: attention only, over K/V gathered beforehand into the
    # contiguous [B, Hkv, MB*bs, Dh] layout (dequantized for 8-bit pools)
    kc = torch.stack([gather_block_kv(pool_layer(kt, i), table, q.dtype)
                      for i in range(n_t)])
    vc = torch.stack([gather_block_kv(pool_layer(vt, i), table, q.dtype)
                      for i in range(n_t)])
    s = mb * bs
    mask = (torch.arange(s, device=dev)[None, :]
            < torch.tensor(n_pos, device=dev)[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)
    gqa = {"enable_gqa": True} if hq != hkv else {}
    library_ms = time_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(
            qs, kc[i], vc[i], attn_mask=mask, **gqa), n_t)
    del kt, vt, kc, vc
    nbytes = (b * hq * dh * 2 * 2                        # q in, attn out
              + 2 * b * hkv * dh * 2                     # k_new, v_new in
              + 2 * b * hkv * dh * itemsize              # the pool writes
              + (2 * b * hkv * 2 if kv else 0)           # their scales
              + b * mb * 4 + b * 4                       # table, idx
              + read)                                    # K, V prefix reads
    return {"b": b, "hq": hq, "hkv": hkv, "dh": dh, "block_size": bs,
            "mb": mb, "pool": kv or "bf16", "idx": list(idx),
            "max_abs_err": err, "tol": DECODE_TOL,
            "pool_bit_identical": True, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention (attention only, no "
                       "gather)", "timing_layers": n_t,
            **_bytes_bound(nbytes, 4 * hq * dh * sum(n_pos))}


LLAMA7B_MATMULS = [("wq", 4096, 4096), ("wk", 4096, 4096),
                   ("wv", 4096, 4096), ("wo", 4096, 4096),
                   ("w_gate", 4096, 11008), ("w_up", 4096, 11008),
                   ("w_down", 11008, 4096)]


def phase_kernels() -> dict:
    s = 1024
    idx = [0, s - 1, s, 17, 500, 733, 256, 1000]
    decode = [check_decode_step(8, 32, 32, s, 128, idx),
              check_decode_step(8, 32, 8, s, 128, idx, seed=1)]
    bidx = [0, 15, 16, 1023, 500, 733, 256, 37]    # the last slot inactive
    block = []
    for hkv in (32, 8):
        for kv in (None, "int8", "fp8"):
            block.append(check_block_decode_step(8, 32, hkv, 128, 16, 64, kv,
                                                 bidx, seed=2))
            torch.cuda.empty_cache()
    matmul = []
    for d, e in ((4096, 4096), (4096, 11008), (11008, 4096)):
        for n in (1, 8, 32):
            matmul.append(check_int8_matmul(n, d, e))
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "fused_decode_step": decode,
          "fused_block_decode_step": block, "int8_matmul_dma": matmul})
    return {"fused_decode_step": decode, "fused_block_decode_step": block,
            "int8_matmul_dma": matmul}


def kernel_summary(kern: dict, launches: dict) -> list:
    """One entry per kernel at the main path's shapes: the MHA decode step at
    8 slots, the MHA block decode step over a bf16 pool at 8 slots, and one
    decode layer's seven int8 matmuls at N = 8 (summed)."""
    dec = kern["fused_decode_step"][0]
    blk = kern["fused_block_decode_step"][0]
    by_shape = {(r["n"], r["d"], r["e"]): r for r in kern["int8_matmul_dma"]}
    layer_rows = [by_shape[(8, d, e)] for _, d, e in LLAMA7B_MATMULS]

    def total(key):
        return sum(r[key] for r in layer_rows)

    mm_bytes = sum(r["bytes"] for r in layer_rows)
    mm_flops = sum(r["flops"] for r in layer_rows)
    return [
        dict(name="fused_decode_step", route="cuda",
             **KERNELS["fused_decode_step"],
             launches=launches["fused_decode_step"],
             max_abs_err=max(r["max_abs_err"]
                             for r in kern["fused_decode_step"]),
             ms=dec["kernel_ms"], plain_ms=dec["plain_ms"],
             bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
             library_ms=dec["library_ms"]),
        dict(name="int8_matmul_dma", route="cuda",
             **KERNELS["int8_matmul_dma"],
             launches=launches["int8_matmul_dma"],
             max_abs_err=max(r["max_abs_err"]
                             for r in kern["int8_matmul_dma"]),
             ms=total("kernel_ms"), plain_ms=total("plain_ms"),
             bound_ms=1e3 * max(mm_bytes / HBM_BYTES_PER_S,
                                mm_flops / BF16_FLOP_PER_S),
             bound_by=("bytes" if mm_bytes / HBM_BYTES_PER_S
                       >= mm_flops / BF16_FLOP_PER_S else "operations"),
             library_ms=total("library_ms")),
        dict(name="fused_block_decode_step", route="cuda",
             **KERNELS["fused_block_decode_step"],
             launches=launches["fused_block_decode_step"],
             max_abs_err=max(r["max_abs_err"]
                             for r in kern["fused_block_decode_step"]),
             ms=blk["kernel_ms"], plain_ms=blk["plain_ms"],
             bound_ms=blk["bound_ms"], bound_by=blk["bound_by"],
             library_ms=blk["library_ms"]),
    ]


# --------------------------------------------------------------- phase 3
def phase_reference() -> dict:
    """A narrow LLaMA (Dh 128, widths that route both kernels) served by the
    port on the CPU — plain versions — and on the card — kernels — with the
    same weights, in fp32: the greedy tokens must be identical."""
    cfg = dict(vocab_size=512, max_seq_len=256, num_layers=2,
               hidden_size=256, num_heads=2, num_kv_heads=2,
               intermediate_size=512)
    rng = np.random.RandomState(7)
    reqs = poisson_trace(rng, 6, rate=1e3, prompt_lens=[5, 40, 100],
                         max_new_choices=[6, 12], vocab_size=512)
    out = {}
    for quant in (False, True):
        toks, params = {}, None
        for device in ("cpu", "cuda"):
            eng = deepspeed_tpu_torch.init_inference(
                LlamaModel(LlamaConfig(**cfg)), dtype="fp32", device=device,
                quant={"enabled": quant}, seed=3,
                params=None if params is None else _tree_to(params, device))
            params = eng.params
            if device == "cpu" and not quant:
                fp32_params = params
            reset_counts()
            srv = ServingEngine(eng, num_slots=4, max_len=256, buckets=(128,))
            toks[device] = {r.rid: r.tokens for r in srv.run(
                [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs])}
            if device == "cuda":
                assert fused_decode_step.launches > 0
                assert (int8_matmul_dma.launches > 0) == quant
        assert toks["cpu"] == toks["cuda"], (quant, toks)
        out["int8" if quant else "fp32"] = sum(map(len, toks["cpu"].values()))
    res = {"phase": "reference", "tokens_compared": out, "identical": True,
           "block_paged": _reference_block(cfg, fp32_params)}
    emit(res)
    return res


def _reference_block(cfg: dict, params) -> dict:
    """The same small fp32 LLaMA, block-paged with a prefix cache: a
    shared-prefix trace over 41-token templates (not a multiple of the
    16-token block, so every hit after the first forks a block), served
    cold and then warm, with the pool in fp32, int8 and fp8. All requests
    arrive at once, so both devices admit in the same order."""
    reqs = shared_prefix_trace(np.random.RandomState(11), 8, rate=1e3,
                               prefix_len=41, suffix_lens=(3, 9, 20),
                               max_new_tokens=8, vocab_size=512)
    kw = dict(num_slots=4, max_len=256, buckets=(32, 64))

    def serve(srv):
        return {r.rid: r.tokens for r in srv.run(
            [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs])}

    out = {}
    for kv in (None, "int8", "fp8"):
        toks, counters = {}, {}
        for device in ("cpu", "cuda"):
            eng = deepspeed_tpu_torch.init_inference(
                LlamaModel(LlamaConfig(**cfg)), dtype="fp32", device=device,
                params=_tree_to(params, device))
            reset_counts()
            srv = ServingEngine(eng, prefix_cache=True, block_size=16,
                                kv_dtype=kv, **kw)
            toks[device] = (serve(srv), serve(srv))       # cold, warm
            counters[device] = (srv.prefill_tokens_computed,
                                srv.prefix.hit_tokens,
                                srv.prefix.blocks_cowed)
            assert srv.prefix.blocks_cowed > 0
            if device == "cuda":
                assert fused_block_decode_step.launches > 0
                assert fused_decode_step.launches == 0
            if kv is None:
                slot = ServingEngine(eng, **kw)
                assert serve(slot) == toks[device][0], \
                    f"block-paged != slot-paged tokens on {device}"
        assert toks["cpu"] == toks["cuda"], (kv, toks)
        assert counters["cpu"] == counters["cuda"], (kv, counters)
        out[kv or "fp32"] = {
            "tokens": 2 * sum(map(len, toks["cpu"][0].values())),
            "prefill_tokens": counters["cpu"][0],
            "hit_tokens": counters["cpu"][1], "forks": counters["cpu"][2]}
    return out


def _tree_to(node, device):
    if isinstance(node, dict):
        return {k: _tree_to(v, device) for k, v in node.items()}
    return node.to(device)


# ------------------------------------------------------------ phases 4-5
def _trace():
    rng = np.random.RandomState(1234)
    return poisson_trace(rng, 12, rate=20.0,
                         prompt_lens=list(range(16, 501)),
                         max_new_choices=list(range(32, 65)),
                         vocab_size=32000)


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs, np.float64), p))


def check_probe(eng, probe, served, tol: float, block_kv="slot") -> dict:
    """The probe request's logits recomputed two ways on the card, in the
    serving dtype: the plain no-cache forward over prompt + served tokens
    (no kernel runs: every block has > 32 rows), and a batch-1 cached replay
    (plain prefill, then one kernel decode step per served token). The
    replay goes through the slot cache (the fused decode step, scalar index)
    or, with ``block_kv`` None / "int8" / "fp8", through a one-slot block
    pool of that type (the block decode step, 16-token blocks). Their
    logits agree within ``tol`` of max |logit|, and every served token whose
    replay top-2 margin exceeds twice the measured difference is the
    replay's argmax."""
    plen = len(probe.prompt)
    seq = torch.tensor([list(probe.prompt) + served[:-1]], device=eng.device)
    with torch.no_grad():
        ref = eng.forward(seq)[0, plen - 1:].float()
    replay = _replay(eng, seq, plen, block_kv)
    assert torch.isfinite(ref).all() and torch.isfinite(replay).all()
    err = (replay - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= tol * scale, f"cached replay vs no-cache: {err} / {scale}"
    top2 = replay.topk(2, dim=-1).values
    safe = ((top2[:, 0] - top2[:, 1]) > 2 * err).tolist()
    picks = replay.argmax(-1).tolist()
    for step, (ok, want, got) in enumerate(zip(safe, picks, served)):
        assert not ok or want == got, f"served token {step}: {got} != {want}"
    return {"rid": probe.rid, "prompt_len": plen, "tokens": len(served),
            "replay": block_kv if block_kv == "slot" else
            "block pool " + (block_kv or str(eng.dtype).split(".")[-1]),
            "logit_max_abs_err": err, "logit_max_abs": scale,
            "tol": tol, "margin_safe_tokens_checked": int(sum(safe))}


def _replay(eng, seq, plen: int, block_kv="slot") -> torch.Tensor:
    """f32 logits ``[T - plen + 1, V]`` of a batch-1 cached replay of
    ``seq``: a plain prefill of its first ``plen`` tokens, then one decode
    step per token (see :func:`check_probe` for ``block_kv``)."""
    model, params = eng.module, eng.params
    with torch.no_grad():
        if block_kv == "slot":
            cache = model.init_cache(1, seq.shape[1], dtype=eng.dtype,
                                     device=eng.device)
        else:
            span = -(-seq.shape[1] // 16) * 16
            pool = BlockKVPool(model, 1, span, block_size=16, dtype=eng.dtype,
                               kv_dtype=block_kv, device=eng.device)
            cache = {"k": pool.k, "v": pool.v,
                     "index": torch.zeros((1,), dtype=torch.int32,
                                          device=eng.device),
                     "block_table": torch.arange(
                         span // 16, dtype=torch.int32,
                         device=eng.device)[None]}
        logits, cache = model.forward_with_cache(params, seq[:, :plen], cache)
        rows = [logits[0, -1]]
        for t in range(plen, seq.shape[1]):
            logits, cache = model.forward_with_cache(params, seq[:, t:t + 1],
                                                     cache)
            rows.append(logits[0, -1])
    return torch.stack(rows).float()


def kv_perturbation(eng, probe, served, kv_dtype: str) -> dict:
    """What an 8-bit pool alone changes: the probe's replay through a
    ``kv_dtype`` block pool against the same replay through a pool in the
    compute dtype (same kernels, same sequence). Per step: the largest
    logit change, and the compute-dtype replay's top-2 margin; a step whose
    margin exceeds twice its own change cannot flip."""
    plen = len(probe.prompt)
    seq = torch.tensor([list(probe.prompt) + served[:-1]], device=eng.device)
    base = _replay(eng, seq, plen, None)
    quant = _replay(eng, seq, plen, kv_dtype)
    diff = (quant - base).abs().amax(-1)
    top2 = base.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    flips = (quant.argmax(-1) != base.argmax(-1))
    return {"steps": int(diff.numel()),
            "logit_change_max": diff.max().item(),
            "logit_change_median": diff.median().item(),
            "top2_margin_median": margin.median().item(),
            "steps_margin_over_2x_change": int((margin > 2 * diff).sum()),
            "argmax_flips": int(flips.sum()),
            "argmax_flips_with_margin_over_2x_change": int(
                (flips & (margin > 2 * diff)).sum())}


def profile_decode(srv, reqs, steps: int = 5) -> dict:
    """Device time of a serving step against its host wall time, over
    ``steps`` steps with every slot holding a live request: the first
    ``num_slots`` of ``reqs``, re-submitted to arrive at once and to outlast
    the profile, are admitted and prefilled by one step first, so the
    profiled steps only decode (block-paged: through the slots' real
    tables). The engine is drained afterwards. Also the five kernels that
    take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    n = srv.num_slots
    for r in reqs[:n]:
        srv.submit(Request(r.rid, r.prompt, steps + 3))
    srv.step()                       # admits and prefills every request
    assert srv.scheduler.waiting == 0 and srv.pending == n, srv.pending
    steps0 = srv.decode_steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        t0 = time.perf_counter()
        for _ in range(steps):
            assert not srv.step()    # decode only: nothing finishes
        wall = time.perf_counter() - t0
    assert srv.decode_steps - steps0 == steps and srv.pending == n
    while srv.pending:
        srv.step()
    kernels = {}
    for ev in pr.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    busy_us = sum(kernels.values())
    assert busy_us > 0, "the profiler saw no device time"
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"steps": steps, "host_ms_per_step": 1e3 * wall / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / 1e6 / wall,
            "top_kernels_ms_per_step": {k[:60]: v / 1e3 / steps for k, v in top}}


def phase_serve(dtype: str, smi: str):
    """Returns the phase's line and the engine (phase 4's serves the
    block-paged phases next)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig.llama_7b()), dtype=dtype, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    srv = ServingEngine(eng, num_slots=8, max_len=1024, buckets=(128, 512))
    t0 = time.perf_counter()
    srv.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reqs = _trace()

    reset_counts()                       # the main path starts here
    t0 = time.perf_counter()
    results = srv.run(reqs, warmup=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    by_rid = {r.rid: r for r in results}
    assert sorted(by_rid) == [r.rid for r in reqs]
    vocab = eng.module.config.vocab_size
    for r in reqs:
        res = by_rid[r.rid]
        assert len(res.tokens) == r.max_new_tokens, (r.rid, len(res.tokens))
        assert all(0 <= t < vocab for t in res.tokens)
    steps = srv.decode_steps
    layers = eng.module.config.num_layers
    assert steps > 0
    assert launches["fused_decode_step"] == layers * steps, (launches, steps)
    want_mm = 7 * layers * steps if dtype == "int8" else 0
    assert launches["int8_matmul_dma"] == want_mm, (launches, steps)
    assert launches["fused_block_decode_step"] == 0, launches

    # solo re-serve: the same request alone gives bit-identical tokens
    probe = max(reqs, key=lambda r: len(r.prompt))
    [solo] = srv.run([Request(probe.rid, probe.prompt, probe.max_new_tokens)],
                     warmup=False)
    assert solo.tokens == by_rid[probe.rid].tokens, "solo != packed tokens"

    check = check_probe(eng, probe, by_rid[probe.rid].tokens, LOGIT_TOL[dtype])
    prof = profile_decode(srv, reqs)

    gen = sum(len(r.tokens) for r in results)
    lat = [r.latency for r in results]
    ttft = [r.first_token_latency for r in results]
    tpot = [(r.finish_time - r.first_token_time) / max(r.decode_calls, 1)
            for r in results]
    info = {"phase": f"serve_{dtype}", "card": smi,
            "model": "llama_7b (32 layers, hidden 4096, 32 heads, "
                     "intermediate 11008, vocab 32000), random weights seed 0",
            "requests": len(results), "tokens_generated": gen,
            "prompt_tokens": sum(len(r.prompt) for r in reqs),
            "decode_steps": steps, "launches": launches,
            "wall_s": wall, "tokens_per_s": gen / wall,
            "decode_wall_s": srv.decode_wall,
            "decode_tokens_per_s": (gen - len(results)) / srv.decode_wall,
            "ms_per_decode_step": 1e3 * srv.decode_wall / steps,
            "latency_p50_s": _pct(lat, 50), "latency_p95_s": _pct(lat, 95),
            "ttft_p50_s": _pct(ttft, 50), "ttft_p95_s": _pct(ttft, 95),
            "tpot_p50_ms": 1e3 * _pct(tpot, 50),
            "solo_identical": True, "probe": check, "decode_profile": prof,
            "init_s": init_s, "warmup_s": warm_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(info)
    return info, eng


def _block_trace():
    """16 requests at 20/s over 2 shared templates of 392 tokens (24.5
    blocks: every hit forks the template's last, partly shared block),
    unique suffixes of 8-100 tokens, 32 new tokens each."""
    return shared_prefix_trace(np.random.RandomState(4321), 16, rate=20.0,
                               prefix_len=392, suffix_lens=range(8, 101),
                               max_new_tokens=32, vocab_size=32000)


def phase_serve_block(eng, kv_dtype, smi: str, baseline=None):
    """Phase 4's bf16 LLaMA-7B engine, block-paged with a prefix cache and
    the pool in bf16 (``kv_dtype`` None) or int8; the trace served cold,
    then again warm on the same index. ``baseline`` (the bf16 pool's cold
    tokens) gives the int8 pool's exact-token rate."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    name = "serve_block_" + ("kv_int8" if kv_dtype else "bf16")
    srv = ServingEngine(eng, num_slots=8, max_len=1024, buckets=(128, 512),
                        prefix_cache=True, block_size=16, kv_dtype=kv_dtype)
    srv.warmup()
    reqs = _block_trace()
    reset_counts()                       # the main path starts here
    runs, steps = {}, 0
    for run in ("cold", "warm"):
        pf0, st0, dw0 = (srv.prefill_tokens_computed, srv.decode_steps,
                         srv.decode_wall)
        hit0, miss0 = srv.prefix.hit_tokens, srv.prefix.miss_tokens
        t0 = time.perf_counter()
        results = srv.run([Request(r.rid, r.prompt, r.max_new_tokens,
                                   arrival_time=r.arrival_time)
                           for r in reqs], warmup=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_rid = {r.rid: r for r in results}
        assert sorted(by_rid) == [r.rid for r in reqs]
        for r in reqs:
            assert len(by_rid[r.rid].tokens) == r.max_new_tokens, r.rid
        n_steps = srv.decode_steps - st0
        steps += n_steps
        gen = sum(len(r.tokens) for r in results)
        hit = srv.prefix.hit_tokens - hit0
        ttft = [r.first_token_latency for r in results]
        runs[run] = {
            "results": by_rid, "wall_s": wall, "tokens_per_s": gen / wall,
            "prefill_tokens_computed": srv.prefill_tokens_computed - pf0,
            "decode_steps": n_steps,
            "ms_per_decode_step": 1e3 * (srv.decode_wall - dw0) / n_steps,
            "ttft_p50_s": _pct(ttft, 50), "ttft_p95_s": _pct(ttft, 95),
            "prefix_hit_rate": hit / (hit + srv.prefix.miss_tokens - miss0)}
    launches = read_counts()
    layers = eng.module.config.num_layers
    assert launches["fused_block_decode_step"] == layers * steps, \
        (launches, steps)
    assert launches["fused_decode_step"] == 0, launches
    assert launches["int8_matmul_dma"] == 0, launches
    cold, warm = runs["cold"], runs["warm"]
    assert (warm["prefill_tokens_computed"]
            <= 0.4 * cold["prefill_tokens_computed"]), runs
    assert srv.prefix.blocks_cowed > 0
    probe = max(reqs, key=lambda r: len(r.prompt))
    check = check_probe(eng, probe, warm["results"][probe.rid].tokens,
                        LOGIT_TOL["bf16"], block_kv=kv_dtype)
    prof = profile_decode(srv, reqs)
    info = {"phase": name, "card": smi,
            "model": "llama_7b, phase 4's engine (bf16, random weights "
                     "seed 0)",
            "pool": kv_dtype or "bf16", "requests": len(reqs),
            "blocks_per_mib": srv.cache.blocks_per_mib(),
            "pool_bytes": srv.cache.hbm_bytes(),
            "blocks_cowed": srv.prefix.blocks_cowed,
            "launches": launches, "decode_steps": steps,
            "probe": check, "decode_profile": prof,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    for run, r in runs.items():
        info[run] = {k: v for k, v in r.items() if k != "results"}
    if baseline is not None:
        same = total = 0
        diverged = {}
        for rid, res in cold["results"].items():
            want = baseline[rid]
            same += sum(a == b for a, b in zip(res.tokens, want))
            total += len(want)
            first = next((i for i, (a, b) in enumerate(zip(res.tokens, want))
                          if a != b), None)
            if first is not None:
                diverged[rid] = first
        info["exact_token_rate_vs_bf16_pool"] = same / total
        info["first_divergence_step_by_rid"] = diverged
        info["kv_perturbation"] = kv_perturbation(
            eng, probe, warm["results"][probe.rid].tokens, kv_dtype)
    emit(info)
    return info, {rid: r.tokens for rid, r in cold["results"].items()}


def phase_probe_fp32() -> dict:
    """LLaMA-7B in fp32 (both kernels take f32): the trace's longest request
    served alone, then its logits checked as in the serving phases, with the
    tight fp32 bound (the kernels' arithmetic at full width and depth)."""
    eng = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig.llama_7b()), dtype="fp32", seed=0)
    srv = ServingEngine(eng, num_slots=8, max_len=1024, buckets=(128, 512))
    probe = max(_trace(), key=lambda r: len(r.prompt))
    [res] = srv.run([Request(probe.rid, probe.prompt, probe.max_new_tokens)])
    assert len(res.tokens) == probe.max_new_tokens
    info = {"phase": "probe_fp32",
            **check_probe(eng, probe, res.tokens, LOGIT_TOL["fp32"])}
    # block-paged, after freeing the slot cache: template + suffix A cold,
    # then the probe, template + suffix B, warm
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    srv = ServingEngine(eng, num_slots=2, max_len=1024, buckets=(128, 512),
                        prefix_cache=True, block_size=16)
    rng = np.random.RandomState(99)
    template = rng.randint(0, 32000, size=392).tolist()
    a, b = (rng.randint(0, 32000, size=n).tolist() for n in (40, 60))
    srv.run([Request(0, template + a, 32)])
    pf0 = srv.prefill_tokens_computed
    reset_counts()
    probe_b = Request(1, template + b, 32)
    [res] = srv.run([probe_b])
    assert fused_block_decode_step.launches == 32 * (len(res.tokens) - 1)
    assert srv.prefix.blocks_cowed == 1
    assert srv.prefill_tokens_computed - pf0 == len(probe_b.prompt) - 392
    info["block_paged"] = {
        "warm_prefill_tokens": srv.prefill_tokens_computed - pf0,
        "hit_tokens": srv.prefix.hit_tokens, "forks": srv.prefix.blocks_cowed,
        **check_probe(eng, probe_b, res.tokens, LOGIT_TOL["fp32"],
                      block_kv=None)}
    emit(info)
    return info


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # fp32 matmuls in full fp32 on the card, as on the CPU (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device()
    kern = phase_kernels()
    phase_reference()
    launches = dict.fromkeys(WRAPPERS, 0)
    for dtype in ("bf16", "int8"):
        info, eng = phase_serve(dtype, dev["nvidia_smi"])
        runs = [info]
        if dtype == "bf16":
            blk, bf16_tokens = phase_serve_block(eng, None, dev["nvidia_smi"])
            runs += [blk, phase_serve_block(eng, "int8", dev["nvidia_smi"],
                                            baseline=bf16_tokens)[0]]
        for run in runs:
            for k in launches:
                launches[k] += run["launches"][k]
        del eng
        gc.collect()                     # free this engine before the next
        torch.cuda.empty_cache()
    phase_probe_fp32()
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": kernel_summary(kern, launches)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
