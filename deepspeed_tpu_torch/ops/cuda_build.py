"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a cold build takes seconds, not minutes). The sources
compile in parallel, one ``nvcc`` per file, and are then linked. The
library lands in ``build/kernels/`` at the repo root (listed in
``.gitignore``), keyed on a hash of the sources and flags, so the first
call after a checkout or an edit rebuilds and every later call loads.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc``. A missing toolchain or a failed
build raises; there is no fallback to the plain versions."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"] + ARCH_FLAGS

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdstorch_kernels_{_key()}.so"


def build(verbose: bool = False) -> Path:
    """Compile (if the hashed library is absent) and return its path. The
    objects build in a private temp dir and the library is renamed into
    place, so processes building at once never load a half-written file."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        failed = []
        for src, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"--- {src.name} (rc={p.returncode}) ---\n{log}")
            elif verbose:
                print(f"--- nvcc {src.name} ---\n{log}", flush=True)
        if failed:
            raise KernelBuildError("\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    build_seconds = time.perf_counter() - t0
    return out


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dst_int8_matmul.argtypes = [
            vp, vp, vp, vp, vp,          # x, w, s, out, partials
            i32, i32, i32, i32, i32,     # n, d, e, layer, k_splits
            i32, vp]                     # dtype code, stream
        lib.dst_int8_matmul.restype = i32
        lib.dst_fused_decode_step.argtypes = [
            vp, vp, vp, vp, vp, vp,      # q, k, v, k_new, v_new, out
            vp, vp, vp,                  # ml, acc (split scratch), idx
            i32, i32,                    # idx scalar, layer
            i32, i32, i32, i32, i32,     # b, hq, hkv, s_max, dh
            i32, i32,                    # chunk, n_splits
            f32, i32, vp]                # scale, dtype code, stream
        lib.dst_fused_decode_step.restype = i32
        lib.dst_fused_block_decode_step.argtypes = [
            vp, vp, vp, vp, vp,          # q, k pool, v pool, k scales, v scales
            vp, vp, vp,                  # k_new, v_new, out
            vp, vp, vp, vp,              # ml, acc (split scratch), idx, table
            i32, i32, i32, i32,          # layer, b, hq, hkv
            i32, i32, i32, i32,          # n_phys, bs, mb, dh
            i32, i32,                    # chunk, n_splits
            f32, i32, i32, vp]           # scale, dtype code, kv code, stream
        lib.dst_fused_block_decode_step.restype = i32
        lib.dst_flash_fwd.argtypes = [
            vp, vp, vp, vp, vp,          # q, k, v, out, lse
            i32, i32, i32, i32, i32,     # bh, tq, tk, dh, causal
            f32, i32, vp]                # scale, dtype code, stream
        lib.dst_flash_fwd.restype = i32
        lib.dst_flash_bwd_dq.argtypes = [
            vp, vp, vp, vp, vp, vp, vp,  # q, k, v, dout, lse, delta, dq
            i32, i32, i32, i32, i32,     # bh, tq, tk, dh, causal
            f32, i32, vp]                # scale, dtype code, stream
        lib.dst_flash_bwd_dq.restype = i32
        lib.dst_flash_bwd_dkv.argtypes = [
            vp, vp, vp, vp, vp, vp,      # q, k, v, dout, lse, delta
            vp, vp,                      # dk, dv
            i32, i32, i32, i32, i32,     # bh, tq, tk, dh, causal
            f32, i32, vp]                # scale, dtype code, stream
        lib.dst_flash_bwd_dkv.restype = i32
        lib.dst_flash_decode.argtypes = [
            vp, vp, vp, vp, vp, vp, vp,  # q, k, v, out, ml, acc, idx
            i32, i32, i32, i32, i32,     # idx scalar, b, hq, hkv, s_max
            i32, i32, i32,               # dh, chunk, n_splits
            f32, i32, i32, vp]           # scale, dtype code, mha, stream
        lib.dst_flash_decode.restype = i32
        lib.dst_int8_matmul_grid.argtypes = [
            vp, vp, vp, vp,              # x, w, s, out
            i32, i32, i32, i32, vp]      # n, d, e, dtype code, stream
        lib.dst_int8_matmul_grid.restype = i32
        lib.dst_block_sparse_fwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp,  # q, k, v, out, lse, lut, count
            i32, i32, i32, i32, i32,     # bh, h, t, dh, block
            i32, i32, f32, i32, vp]      # lut width, causal, scale, dtype, stream
        lib.dst_block_sparse_fwd.restype = i32
        lib.dst_block_sparse_bwd_dq.argtypes = [
            vp, vp, vp, vp, vp, vp, vp,  # q, k, v, dout, lse, delta, dq
            vp, vp, vp, vp,              # lut, work items, merge list, partials
            i32, i32, i32,               # items, merges, partial slots
            i32, i32, i32, i32, i32,     # bh, h, t, dh, block
            i32, i32, f32, i32, vp]      # lut width, causal, scale, dtype, stream
        lib.dst_block_sparse_bwd_dq.restype = i32
        lib.dst_block_sparse_bwd_dkv.argtypes = [
            vp, vp, vp, vp, vp, vp,      # q, k, v, dout, lse, delta
            vp, vp, vp,                  # dk, dv, transposed lut
            vp, vp, vp,                  # work items, merge list, partials
            i32, i32, i32,               # items, merges, partial slots
            i32, i32, i32, i32, i32,     # bh, h, t, dh, block
            i32, i32, f32, i32, vp]      # lut width, causal, scale, dtype, stream
        lib.dst_block_sparse_bwd_dkv.restype = i32
        lib.dst_error_string.argtypes = [i32]
        lib.dst_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index`` (the split
    plans of the decode kernels size their grids by it)."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.dst_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def dtype_code(dtype) -> int:
    import torch

    codes = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
    if dtype not in codes:
        raise TypeError(f"kernels take float32/float16/bfloat16, got {dtype}")
    return codes[dtype]
