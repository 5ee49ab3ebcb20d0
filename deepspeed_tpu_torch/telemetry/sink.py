"""Structured JSONL sink of the port (port of
deepspeed_tpu/telemetry/sink.py): the durable half of the telemetry.

One record per line, append-only, buffered on the host. Record kinds:

  {"ts": ..., "kind": "scalar",   "tag": ..., "value": ..., "step": ...}
  {"ts": ..., "kind": "event",    "name": ..., **fields}
  {"ts": ..., "kind": "snapshot", "step": ..., "metrics": {...}}

``ts`` is wall-clock epoch seconds, stamped at write. Writes are buffered
(``flush_every`` records), so the hot loop pays a dict and a list append,
not a system call; ``flush()``/``close()`` drain. I/O errors are swallowed
after one warning and counted: telemetry must never take down the job it
observes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional


class JsonlSink:
    def __init__(self, path: str, flush_every: int = 64):
        self.path = path
        self.flush_every = max(int(flush_every), 1)
        self._buf: List[str] = []
        self._lock = threading.Lock()
        self._fh = None
        self._warned = False
        self.records_written = 0
        # every record this sink failed to write (serialization errors and
        # failed drains), so a reader can tell whether the file is complete
        self.records_dropped = 0
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    def _warn_once(self, e: Exception) -> None:
        if not self._warned:
            self._warned = True
            from deepspeed_tpu_torch.utils.logging import logger

            logger.warning(f"telemetry sink {self.path}: {type(e).__name__}: "
                           f"{e}; further records dropped (counted in "
                           f"telemetry/events_dropped)")

    def _note_dropped(self, n: int) -> None:
        self.records_dropped += n
        try:
            from deepspeed_tpu_torch.telemetry.registry import get_registry

            get_registry().counter("telemetry/events_dropped").inc(n)
        except Exception:
            pass

    def write(self, record: dict) -> None:
        rec = dict(record)
        rec.setdefault("ts", time.time())
        try:
            line = json.dumps(rec, default=str)
        except Exception as e:
            self._warn_once(e)
            self._note_dropped(1)
            return
        with self._lock:
            self._buf.append(line)
            if len(self._buf) >= self.flush_every:
                self._drain_locked()

    def scalar(self, tag: str, value: float, step: int) -> None:
        """A monitor event's shape."""
        self.write({"kind": "scalar", "tag": tag, "value": value, "step": step})

    def _drain_locked(self) -> None:
        if not self._buf:
            return
        try:
            if self._fh is None:
                self._fh = open(self.path, "a")
            self._fh.write("\n".join(self._buf) + "\n")
            self._fh.flush()
            self.records_written += len(self._buf)
        except Exception as e:
            self._warn_once(e)
            self._note_dropped(len(self._buf))
        finally:
            self._buf.clear()

    def flush(self) -> None:
        with self._lock:
            self._drain_locked()

    def close(self) -> None:
        with self._lock:
            self._drain_locked()
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:
                    pass
                self._fh = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str, *, return_bad: bool = False):
    """Parse a telemetry JSONL file, tolerating a crash mid-write: a
    truncated or corrupt line (torn JSON, undecodable bytes, a non-object
    value) is skipped and counted, never raised. The file is read as bytes
    (a write torn inside a multi-byte UTF-8 sequence would make text-mode
    iteration raise) and each line decoded leniently.

    Returns the parsed records; with ``return_bad=True`` returns
    ``(records, n_bad_lines)`` so callers can surface the damage."""
    out: List[dict] = []
    bad = 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("utf-8", errors="replace").strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                bad += 1
                continue
            if not isinstance(rec, dict):
                bad += 1
                continue
            out.append(rec)
    return (out, bad) if return_bad else out
