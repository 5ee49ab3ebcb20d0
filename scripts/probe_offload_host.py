"""Measure the host side of ZeRO-Offload on the machine it runs on: the
host Adam kernel's sweep rate beside plain streaming ops, and the async IO
engine's file rates.

    python3 scripts/probe_offload_host.py [--dir DIR] [--gb 4] [--elements 268435456]

Prints one JSON line per measurement:

* ``host_sweep``: ``cpu_adam_native.adam_step_fused`` (f32 grad scaled,
  AdamW, bf16 image out: 30 bytes an element) against ``Tensor.add_`` (12
  bytes) and ``Tensor.copy_`` (8 bytes) on ``--elements`` f32 elements, at
  one thread and at every usable core (the kernel's OpenMP team and
  torch's intra-op team set alike), best of three, in GB/s;
* ``aio``: a ``--gb`` GB tensor written and read back through
  ``ops.aio.AsyncIOHandle`` (8 threads) to ``DIR/probe.bin`` (default the
  repo's ``build/``, where chip_smoke.py puts the swap files), in GB/s;
  the read follows the write, so it may come from the page cache. The file
  is removed after.

Runs on the CPU alone; the host kernels build into ``build/native`` on
first use.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from deepspeed_tpu_torch.ops import cpu_adam_native as cna  # noqa: E402
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle  # noqa: E402


def _best(fn, reps: int = 3) -> float:
    best = float("inf")
    for i in range(reps):
        t0 = time.perf_counter()
        fn(i)
        best = min(best, time.perf_counter() - t0)
    return best


def host_sweep(n: int) -> None:
    p, g = torch.randn(n), torch.randn(n)
    m, v = torch.zeros(n), torch.zeros(n)
    img = torch.empty(n, dtype=torch.bfloat16)
    cores = len(os.sched_getaffinity(0))
    for threads in sorted({1, cores}):
        cna.set_num_threads(threads)
        torch.set_num_threads(threads)
        rates = {
            "adam_step_fused": 30 * n / _best(lambda i: cna.adam_step_fused(
                p, g, m, v, step=i + 1, lr=1e-4, weight_decay=0.01,
                grad_scale=0.5, emit_bf16=True, out=img)),
            "add_": 12 * n / _best(lambda i: m.add_(g)),
            "copy_": 8 * n / _best(lambda i: m.copy_(g)),
        }
        print(json.dumps({"host_sweep": {"threads": threads, "elements": n,
                                         "gb_per_s": {k: r / 1e9 for k, r
                                                      in rates.items()}}}),
              flush=True)


def aio_rates(folder: Path, gb: float) -> None:
    folder.mkdir(parents=True, exist_ok=True)
    path = str(folder / "probe.bin")
    buf = torch.ones(int(gb * 1e9) // 4)
    nbytes = buf.numel() * 4
    handle = AsyncIOHandle(num_threads=8)
    try:
        t0 = time.perf_counter()
        handle.sync_pwrite(buf, path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        handle.sync_pread(buf, path)
        read_s = time.perf_counter() - t0
    finally:
        os.remove(path)
    print(json.dumps({"aio": {"dir": str(folder), "bytes": nbytes,
                              "write_gb_per_s": nbytes / write_s / 1e9,
                              "read_gb_per_s": nbytes / read_s / 1e9}}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", type=Path, default=ROOT / "build")
    ap.add_argument("--gb", type=float, default=4.0)
    ap.add_argument("--elements", type=int, default=1 << 28)
    args = ap.parse_args()
    host_sweep(args.elements)
    aio_rates(args.dir, args.gb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
