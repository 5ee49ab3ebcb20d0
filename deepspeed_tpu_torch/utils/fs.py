"""Durable filesystem primitives for checkpointing (copy of
deepspeed_tpu/utils/fs.py for the PyTorch port: the same names and the same
failure behaviour).

Every checkpoint byte goes through this module so that (a) transient
filesystem errors (network-filesystem hiccups, timeouts) are retried with
exponential backoff + jitter, (b) publication is atomic — a file is either
the complete old version or the complete new version, never a torn write —
and (c) tests can inject faults at one seam (they patch the functions
here).
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional, Tuple, Type

from deepspeed_tpu_torch.utils.logging import logger

# Module-level knobs (read at call time so tests / deployments can tune them
# without threading parameters through every caller).
DEFAULT_RETRIES = 4
DEFAULT_BASE_DELAY_S = 0.05
DEFAULT_MAX_DELAY_S = 2.0
DEFAULT_JITTER = 0.5

# Errors that signal a *permanent* condition — retrying cannot help and only
# delays the real traceback.
NON_RETRYABLE = (FileNotFoundError, IsADirectoryError, NotADirectoryError,
                 PermissionError)

TMP_SUFFIX = ".tmp"


def retry_io(fn: Callable, *, retries: Optional[int] = None,
             base_delay_s: Optional[float] = None,
             max_delay_s: Optional[float] = None,
             jitter: Optional[float] = None,
             retry_on: Tuple[Type[BaseException], ...] = (OSError,),
             description: str = ""):
    """Call ``fn()`` retrying transient I/O errors.

    Exponential backoff (``base * 2**attempt``) capped at ``max_delay_s``,
    with multiplicative jitter in ``[1-jitter, 1+jitter]`` so a pod's worth
    of workers retrying the same flaky filesystem don't stampede in sync.
    ``NON_RETRYABLE`` errors re-raise immediately.
    """
    retries = DEFAULT_RETRIES if retries is None else retries
    base_delay_s = DEFAULT_BASE_DELAY_S if base_delay_s is None else base_delay_s
    max_delay_s = DEFAULT_MAX_DELAY_S if max_delay_s is None else max_delay_s
    jitter = DEFAULT_JITTER if jitter is None else jitter
    attempt = 0
    while True:
        try:
            return fn()
        except NON_RETRYABLE:
            raise
        except retry_on as e:
            attempt += 1
            if attempt > retries:
                raise
            delay = min(max_delay_s, base_delay_s * (2 ** (attempt - 1)))
            delay *= 1.0 + jitter * random.uniform(-1.0, 1.0)
            delay = max(delay, 0.0)
            logger.warning(
                f"transient I/O error{' in ' + description if description else ''}"
                f" ({type(e).__name__}: {e}); retry {attempt}/{retries} "
                f"in {delay:.3f}s")
            time.sleep(delay)


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def write_bytes(path: str, data: bytes) -> None:
    """Write + flush + fsync. Reopening with 'wb' truncates, so a retry
    after a partial write starts clean."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def stream_write(path: str, writer: Callable) -> None:
    """``writer(fileobj)`` streams content to ``path``; flush + fsync before
    close. Lets large payloads (np.savez zips) go straight to disk without
    an in-memory copy of the serialized form."""
    with open(path, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())


def replace(src: str, dst: str) -> None:
    os.replace(src, dst)


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync so a rename survives power loss; some
    filesystems (and all object-store fuses) don't support it."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, **retry_kw) -> None:
    """Durably publish ``data`` at ``path``: write to ``path + '.tmp'``
    (retried), then ``os.replace`` onto the final name. Readers never
    observe a torn file; a crash mid-write leaves the previous version (or
    nothing) at ``path`` plus at most a stale ``.tmp``."""
    _atomic_publish(path, lambda tmp: retry_io(
        lambda: write_bytes(tmp, data), description=f"write {tmp}", **retry_kw),
        **retry_kw)


def atomic_stream_write(path: str, writer: Callable, **retry_kw) -> None:
    """Atomic publish for streamed payloads: ``writer(fileobj)`` runs
    against ``path + '.tmp'`` (retried — rewinding is the writer's job is
    NOT assumed, each retry reopens a truncated file and calls ``writer``
    afresh), then the tmp is renamed onto the final name."""
    _atomic_publish(path, lambda tmp: retry_io(
        lambda: stream_write(tmp, writer), description=f"write {tmp}",
        **retry_kw), **retry_kw)


def _atomic_publish(path: str, write_tmp: Callable, **retry_kw) -> None:
    tmp = path + TMP_SUFFIX
    try:
        write_tmp(tmp)
        retry_io(lambda: replace(tmp, path),
                 description=f"publish {path}", **retry_kw)
    except BaseException:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(path) or ".")


def atomic_write_text(path: str, text: str, **retry_kw) -> None:
    atomic_write_bytes(path, text.encode("utf-8"), **retry_kw)


def read_bytes_with_retry(path: str, **retry_kw) -> bytes:
    return retry_io(lambda: read_bytes(path),
                    description=f"read {path}", **retry_kw)
