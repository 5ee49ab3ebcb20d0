"""On-card smoke run of the PyTorch port (deepspeed_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device    — nvidia-smi's name and power limit; builds the CUDA kernels
               from deepspeed_tpu_torch/csrc (nvcc, sm_90a) and times it.
2. kernels   — each hand-written kernel against its plain PyTorch version on
               the card at the serving path's full LLaMA-7B shapes (fused
               decode step: 8 slots x 32 heads x Dh 128 x S 1024, per-slot
               lengths incl. 0, S-1 and S, plus a GQA rep-4 case; int8
               matmul: the three block shapes at N in {1, 8, 32}, stacked,
               last layer). Written cache bytes must be bit-identical.
               Times are device times: 20 launches on inputs rotated
               through more than the 50 MB L2 are captured in a CUDA graph,
               whose replay is timed with CUDA events (median of 20).
3. reference — a small LLaMA served by the port on the CPU (plain versions)
               and on the card (kernels), fp32 with and without int8 block
               weights: identical greedy tokens.
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
               margin-safe steps; a profile of five decode steps gives the
               device's busy share and its top kernels.
6. probe_fp32 — LLaMA-7B in fp32: the trace's longest request served alone,
               its kernel-cached replay held to the no-cache forward within
               1e-3 of max |logit|, and its served tokens to the replay.

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
from deepspeed_tpu_torch.ops.decode_step import (fused_decode_step,
                                                 fused_decode_step_plain)
from deepspeed_tpu_torch.ops.int8_matmul import (int8_matmul_dma,
                                                 int8_matmul_plain)
from deepspeed_tpu_torch.serving import Request, ServingEngine, poisson_trace

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
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_counts() -> None:
    fused_decode_step.launches = 0
    int8_matmul_dma.launches = 0


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


LLAMA7B_MATMULS = [("wq", 4096, 4096), ("wk", 4096, 4096),
                   ("wv", 4096, 4096), ("wo", 4096, 4096),
                   ("w_gate", 4096, 11008), ("w_up", 4096, 11008),
                   ("w_down", 11008, 4096)]


def phase_kernels() -> dict:
    s = 1024
    idx = [0, s - 1, s, 17, 500, 733, 256, 1000]
    decode = [check_decode_step(8, 32, 32, s, 128, idx),
              check_decode_step(8, 32, 8, s, 128, idx, seed=1)]
    matmul = []
    for d, e in ((4096, 4096), (4096, 11008), (11008, 4096)):
        for n in (1, 8, 32):
            matmul.append(check_int8_matmul(n, d, e))
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "fused_decode_step": decode,
          "int8_matmul_dma": matmul})
    return {"fused_decode_step": decode, "int8_matmul_dma": matmul}


def kernel_summary(kern: dict, launches: dict) -> list:
    """One entry per kernel at the main path's shapes: the MHA decode step at
    8 slots, and one decode layer's seven int8 matmuls at N = 8 (summed)."""
    dec = kern["fused_decode_step"][0]
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
            reset_counts()
            srv = ServingEngine(eng, num_slots=4, max_len=256, buckets=(128,))
            toks[device] = {r.rid: r.tokens for r in srv.run(
                [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs])}
            if device == "cuda":
                assert fused_decode_step.launches > 0
                assert (int8_matmul_dma.launches > 0) == quant
        assert toks["cpu"] == toks["cuda"], (quant, toks)
        out["int8" if quant else "fp32"] = sum(map(len, toks["cpu"].values()))
    res = {"phase": "reference", "tokens_compared": out, "identical": True}
    emit(res)
    return res


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


def check_probe(eng, probe, served, tol: float) -> dict:
    """The probe request's logits recomputed two ways on the card, in the
    serving dtype: the plain no-cache forward over prompt + served tokens
    (no kernel runs: every block has > 32 rows), and a batch-1 cached replay
    (plain prefill, then one kernel decode step per served token, scalar
    index). Their logits agree within ``tol`` of max |logit|, and every
    served token whose replay top-2 margin exceeds twice the measured
    difference is the replay's argmax."""
    model, params = eng.module, eng.params
    plen = len(probe.prompt)
    seq = torch.tensor([list(probe.prompt) + served[:-1]], device=eng.device)
    with torch.no_grad():
        ref = eng.forward(seq)[0, plen - 1:].float()
        cache = model.init_cache(1, seq.shape[1], dtype=eng.dtype,
                                 device=eng.device)
        logits, cache = model.forward_with_cache(params, seq[:, :plen], cache)
        rows = [logits[0, -1]]
        for t in range(plen, seq.shape[1]):
            logits, cache = model.forward_with_cache(params, seq[:, t:t + 1],
                                                     cache)
            rows.append(logits[0, -1])
    replay = torch.stack(rows).float()
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
            "logit_max_abs_err": err, "logit_max_abs": scale,
            "tol": tol, "margin_safe_tokens_checked": int(sum(safe))}


def profile_decode(srv, steps: int = 5) -> dict:
    """Device time of the decode step against its host wall time, over
    ``steps`` steps of the finished engine (every slot inactive at its stale
    length: the same kernels and shapes as a full batch), with the five
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    n = srv.num_slots
    toks = torch.zeros((n,), dtype=torch.int32, device=srv.device)
    idle = torch.zeros((n,), dtype=torch.bool, device=srv.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        t0 = time.perf_counter()
        for _ in range(steps):
            out = srv._decode(srv.engine.params, *srv.cache.carry(), toks, idle)
            srv.cache.update(*out[:3])
            out[3].cpu()
        wall = time.perf_counter() - t0
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


def phase_serve(dtype: str, smi: str) -> dict:
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
    launches = {"fused_decode_step": fused_decode_step.launches,
                "int8_matmul_dma": int8_matmul_dma.launches}

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

    # solo re-serve: the same request alone gives bit-identical tokens
    probe = max(reqs, key=lambda r: len(r.prompt))
    [solo] = srv.run([Request(probe.rid, probe.prompt, probe.max_new_tokens)],
                     warmup=False)
    assert solo.tokens == by_rid[probe.rid].tokens, "solo != packed tokens"

    check = check_probe(eng, probe, by_rid[probe.rid].tokens, LOGIT_TOL[dtype])
    prof = profile_decode(srv)

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
    return info


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
    launches = {"fused_decode_step": 0, "int8_matmul_dma": 0}
    for dtype in ("bf16", "int8"):
        info = phase_serve(dtype, dev["nvidia_smi"])
        for k in launches:
            launches[k] += info["launches"][k]
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
