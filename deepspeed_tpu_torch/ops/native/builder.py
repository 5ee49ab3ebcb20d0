"""Build and load the port's host (C++) kernels: the counterpart of
deepspeed_tpu/ops/native/builder.py beside ``ops/cuda_build.py``.

The sources are the JAX package's own host kernels, copied into
``deepspeed_tpu_torch/csrc/`` (``adam/dstpu_cpu_adam.cpp``,
``aio/dstpu_aio.cpp``). Each op compiles into one plain C shared library,
loaded with ``ctypes``:

  sources -> g++ -O3 -std=c++17 -fPIC -shared -pthread [-fopenmp] [SIMD]
          -> build/native/<name>-<hash>.so -> ctypes.CDLL

``SIMD`` is the widest of ``-mavx512f`` / ``-mavx2`` that the compiler
accepts and this host runs (a probe program built with the flag must run
and find the ISA), in the reference's order. The library lands in the
repo's git-ignored ``build/`` at first use, keyed on a hash of the sources,
the compiler and the flags. Nothing builds at import time. A missing
compiler or a failed build raises :class:`NativeBuildError`; no caller
falls back to numpy or to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

from deepspeed_tpu_torch.ops.registry import OpBuilder
from deepspeed_tpu_torch.utils.logging import logger

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "native"
BASE_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
# widest first, as the reference probes them
SIMD_FLAGS = (("-mavx512f", "avx512f"), ("-mavx2", "avx2"))


class NativeBuildError(RuntimeError):
    """No C++ compiler, or the compiler refused a source."""


def compiler() -> Optional[str]:
    for cc in ("g++", "c++", "clang++"):
        if shutil.which(cc):
            return cc
    return None


@functools.lru_cache(maxsize=None)
def _runs(cc: str, flag: str, isa: Optional[str]) -> bool:
    """Does ``cc`` accept ``flag``, and (for a SIMD flag) does this host
    run the ISA it enables?"""
    body = (f'return __builtin_cpu_supports("{isa}") ? 0 : 1;' if isa
            else "return 0;")
    with tempfile.TemporaryDirectory() as td:
        src, exe = Path(td) / "probe.cpp", Path(td) / "probe"
        src.write_text(f"int main() {{ {body} }}\n")
        try:
            if subprocess.run([cc, flag, str(src), "-o", str(exe)],
                              capture_output=True, timeout=60).returncode:
                return False
            return subprocess.run([str(exe)], capture_output=True,
                                  timeout=60).returncode == 0
        except (OSError, subprocess.SubprocessError):
            return False


def flags(want_openmp: bool, want_simd: bool) -> List[str]:
    """The compiler and flags a build would use (raises with no compiler)."""
    cc = compiler()
    if cc is None:
        raise NativeBuildError("no C++ compiler found (g++, c++, clang++)")
    out = [cc] + BASE_FLAGS
    if want_openmp and _runs(cc, "-fopenmp", None):
        out.append("-fopenmp")
    if want_simd:
        for flag, isa in SIMD_FLAGS:
            if _runs(cc, flag, isa):
                out.append(flag)
                break
    return out


def build_native_lib(name: str, sources: Sequence[str], want_openmp: bool = False,
                     want_simd: bool = False) -> Path:
    """Compile ``sources`` (paths under csrc/) into ``build/native`` unless
    the hashed library is there; return its path."""
    cmd = flags(want_openmp, want_simd)
    srcs = [CSRC / s for s in sources]
    h = hashlib.sha256(" ".join(cmd).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")  # builders may race
    full = cmd + [str(s) for s in srcs] + ["-o", str(tmp)]
    logger.info(f"building native op '{name}': {' '.join(full)}")
    r = subprocess.run(full, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise NativeBuildError(f"native build of '{name}' failed:\n{r.stderr}")
    os.replace(tmp, out)
    return out


class NativeOpBuilder(OpBuilder):
    """An op backed by a host C++ library (the async IO engine, the host
    optimizer kernels), made by ops/__init__.py's proxies with the CPU's
    accelerator: the library runs on host memory whatever card the process
    has."""

    SOURCES: List[str] = []
    WANT_OPENMP = False
    WANT_SIMD = False

    def is_compatible(self, verbose: bool = False) -> bool:
        ok = compiler() is not None and all((CSRC / s).exists()
                                            for s in self.SOURCES)
        if not ok and verbose:
            logger.warning(f"{self.NAME}: {self.compatibility_reason()}")
        return ok

    def compatibility_reason(self) -> str:
        if compiler() is None:
            return "no C++ compiler found"
        missing = [s for s in self.SOURCES if not (CSRC / s).exists()]
        return f"missing sources: {missing}" if missing else "compatible"

    def build_flags(self) -> List[str]:
        return flags(self.WANT_OPENMP, self.WANT_SIMD)

    def load_library(self) -> ctypes.CDLL:
        return ctypes.CDLL(str(build_native_lib(
            self.NAME, self.SOURCES, want_openmp=self.WANT_OPENMP,
            want_simd=self.WANT_SIMD)))
