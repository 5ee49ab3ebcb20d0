"""Time the port's block-sparse kernels and int8 matmuls on one CUDA card,
from any checkout of the repo (so that two commits compare in one run).

    python3 scripts/time_port_kernels.py --root DIR [--label NAME] [--define X=1 ...]

imports ``deepspeed_tpu_torch`` and ``chip_smoke`` from ``DIR`` (built
there on first use) and prints one JSON line with device times from
``chip_smoke.time_ms`` (launches captured in a CUDA graph over two input
sets, which together exceed the 50 MB L2; the median replay):

* ``sparse``: the forward, dQ and dK/dV at ``chip_smoke.py``'s rows (a)
  (Fixed causal, 32 heads x Dh 128, bf16, B 1, T 8192) and (b) (BigBird,
  16 x Dh 64, B 4, T 4096), block 16;
* ``int8``: LLaMA-7B's seven decode matmuls at N 1, 8 and 32 in bf16, the
  gridded form (``int8_matmul``) and kernel 2 (``int8_matmul_dma``, timed
  before and after the gridded form), per shape and summed over the layer,
  on enough stacked layers that one rotation exceeds the L2.

``--grid-cols`` times only the gridded form at every column tile that
``int8_matmul.GRID_COLS`` lists (each forced through the library, in the
order given and then reversed), at N 1, 8 and 32 in bf16, on the matmuls
of LLaMA-7B, CodeLlama-34B and GPT-2 774M, and holds each result against
``int8_matmul_plain``.

``--define`` adds ``-D`` flags to the kernel build (a variant build of the
same sources, under its own hashed library). To compare two commits, unpack
one with ``git archive`` into a directory that ``.gitignore`` lists and run
the script in turns, the one commit, the other, the other, the one, on one
card in one call.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default=None)
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--grid-cols", action="store_true")
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_port_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import cuda_build, get_op_builder
    from deepspeed_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_dma
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    assert Path(bs.__file__).resolve().is_relative_to(root), bs.__file__
    cuda_build.NVCC_FLAGS = cuda_build.NVCC_FLAGS + [f"-D{d}" for d in args.define]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = "cuda"
    if args.grid_cols:
        print(json.dumps({"label": args.label or root, "device": smi,
                          "grid_cols": grid_cols(cs, dev)}), flush=True)
        return 0
    sa = get_op_builder("sparse_attn")().load()
    sparse = {}
    for name, cfg, b, t, h, dh in (
            ("a", sa.FixedSparsityConfig(num_heads=32, block=16, num_local_blocks=4,
                                         num_global_blocks=1,
                                         attention="unidirectional"), 1, 8192, 32, 128),
            ("b", sa.BigBirdSparsityConfig(num_heads=16, block=16), 4, 4096, 16, 64)):
        layout = cfg.make_layout(t)
        luts = bs.sparse_luts(layout, dev)
        kw = dict(block=16, causal=cfg.attention == "unidirectional")
        g = torch.Generator(device=dev).manual_seed(0)
        sets = [[torch.randn((b * h, t, dh), generator=g, device=dev).to(torch.bfloat16)
                 for _ in range(4)] for _ in range(2)]
        rows = []
        for qq, kk, vv, dd in sets:
            o, lse = bs.block_sparse_fwd_plain(qq, kk, vv, luts, **kw)
            rows.append((lse, bs.block_sparse_delta(dd, o)))
        fwd = cs.time_ms(lambda i: bs.block_sparse_fwd(*sets[i][:3], luts, **kw), 2,
                         per=5, reps=5)
        dq = cs.time_ms(lambda i: bs.block_sparse_bwd_dq(*sets[i], *rows[i], luts, **kw),
                        2, per=5, reps=5)
        dkv = cs.time_ms(lambda i: bs.block_sparse_bwd_dkv(*sets[i], *rows[i], luts, **kw),
                         2, per=5, reps=5)
        active = int(layout.sum()) * b
        sparse[name] = {"fwd_ms": fwd, "dq_ms": dq, "dkv_ms": dkv,
                        "total_ms": fwd + dq + dkv,
                        "fwd_f32_floor_ms": 1e3 * 4 * 16 * 16 * dh * active
                        / cs.F32_FLOP_PER_S}
        del sets, rows
        torch.cuda.empty_cache()
    int8 = {}
    for n in (1, 8, 32):
        per = {}
        for d, e in ((4096, 4096), (4096, 11008), (11008, 4096)):
            layers = max(2, math.ceil(3 * cs.L2_BYTES / (d * e)))
            g = torch.Generator(device=dev).manual_seed(n)
            q = torch.randint(-128, 128, (layers, d, e), generator=g, device=dev,
                              dtype=torch.int8)
            s = torch.rand((layers, 1, e), generator=g, device=dev) * 0.02
            x = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
            # kernel 2 before and after the gridded form (a kernel timed
            # right after a long run of another can find the card's clocks
            # lower)
            row = {"dma_ms": cs.time_ms(lambda i: int8_matmul_dma(x, q, s, i), layers)}
            row["grid_ms"] = cs.time_ms(lambda i: int8_matmul(x, q[i], s[i]), layers)
            row["dma_after_grid_ms"] = cs.time_ms(lambda i: int8_matmul_dma(x, q, s, i),
                                                  layers)
            per[f"{d}x{e}"] = row
            del q, s
            torch.cuda.empty_cache()
        layer = {k: sum(per[f"{d}x{e}"][k] for _, d, e in cs.LLAMA7B_MATMULS)
                 for k in ("grid_ms", "dma_ms", "dma_after_grid_ms")}
        int8[f"n{n}"] = {"layer": layer, "per_shape": per}
    print(json.dumps({"label": args.label or root, "defines": args.define,
                      "device": smi,
                      "sparse": sparse, "int8": int8}), flush=True)
    return 0


# (D, E) of each model's decode matmuls: LLaMA-7B; CodeLlama-34B (GQA, 8
# KV heads of 128); GPT-2 774M
GRID_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096),
               (8192, 8192), (8192, 1024), (8192, 22016), (22016, 8192),
               (1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280))


def grid_cols(cs, dev: str) -> dict:
    """The gridded form at each column tile of ``GRID_COLS``, forced through
    the library (its ring ``big`` where the tile's blocks fit one wave, as
    ``grid_plan`` gives it): per shape and N, the device time of each, the
    tile ``grid_plan`` picks and each tile's largest error against the
    plain version (which must stay within bf16's rounding)."""
    import torch
    from deepspeed_tpu_torch.ops import cuda_build
    from deepspeed_tpu_torch.ops import int8_matmul as tmm

    lib = cuda_build.kernels()
    order = list(tmm.GRID_COLS) + list(reversed(tmm.GRID_COLS))

    def forced(x, q, s, cols):
        n, d = x.shape
        e = q.shape[1]
        out = torch.empty((n, e), dtype=x.dtype, device=x.device)
        err = lib.dst_int8_matmul_grid(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), n, d, d, e,
            cols, int(-(-e // cols) <= tmm.WAVE_SMS), cuda_build.dtype_code(x.dtype),
            torch.cuda.current_stream(x.device).cuda_stream)
        cuda_build.check(lib, err, f"int8_matmul_grid cols {cols}")
        return out

    rows = {}
    for d, e in GRID_SHAPES:
        layers = max(2, math.ceil(3 * cs.L2_BYTES / (d * e)))
        g = torch.Generator(device=dev).manual_seed(d + e)
        q = torch.randint(-128, 128, (layers, d, e), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand((layers, 1, e), generator=g, device=dev) * 0.02
        for n in (1, 8, 32):
            x = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
            ref = tmm.int8_matmul_plain(x, q[0], s[0]).float()
            row = {"plan": list(tmm.grid_plan(d, e))}
            for cols in tmm.GRID_COLS:
                err = (forced(x, q[0], s[0], cols).float() - ref).abs()
                assert (err <= 8e-3 * ref.abs() + 1e-3).all(), (d, e, n, cols)
                row[f"err_{cols}"] = err.max().item()
            for k, cols in enumerate(order):
                row[f"ms_{cols}_{k}"] = cs.time_ms(
                    lambda i: forced(x, q[i], s[i], cols), layers)
            rows[f"{d}x{e}_n{n}"] = row
        del q, s
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())
