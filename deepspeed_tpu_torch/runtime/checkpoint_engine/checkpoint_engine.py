"""Checkpoint engines (port of
deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py): the
``CheckpointEngine`` interface, the npz-backed ``NativeCheckpointEngine``
and its background-thread wrapper ``AsyncCheckpointEngine``.

The file format is the reference's, byte for byte in what it stores, so a
tag written by either package loads into the other:

* one ``state.npz`` per tag, arrays keyed ``<section>::<path>`` where the
  path is the reference's ``jax.tree_util`` key path joined by ``/``: a
  dict key, a list index, a ``NamedTuple`` field name (``AdamState``'s
  ``step`` / ``exp_avg`` / ``exp_avg_sq``, the loss scaler's four fields);
* bf16 and fp16 arrays stored as their uint16 bits under ``<key>@bf16`` /
  ``<key>@f16`` (npz cannot hold bf16). bf16 is read back through
  ``torch.from_numpy(bits).view(torch.bfloat16)``: numpy has no bf16 and
  the port does not depend on a package that adds one;
* host scalars of the port's state (the optimizer's ``step``, the scaler's
  fields) stored as the reference's device scalars: ints as int32, floats
  as float32;
* ``__meta__``: a JSON string with the crc32 / dtype / shape manifest of
  every stored array under ``__integrity__``, verified on load.

The Orbax engine is JAX-only and is refused by name.
"""

from __future__ import annotations

import abc
import copy
import json
import os
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.utils import fs
from deepspeed_tpu_torch.utils.logging import log_dist, logger

MANIFEST_KEY = "__integrity__"
MANIFEST_VERSION = 1


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity verification (truncated file, checksum
    mismatch, missing/extra arrays, or absent manifest where required)."""


class CheckpointEngine(abc.ABC):
    def __init__(self, config_params=None):
        self.config = config_params

    def create(self, tag: str):
        """Notify start of a checkpoint under ``tag`` (reference create())."""

    @abc.abstractmethod
    def save(self, state_dict: Dict[str, Any], path: str, on_success=None):
        """Persist ``state_dict``. ``on_success`` (if given) runs exactly
        once after the state is durably written: sidecar finalization like
        the 'latest' pointer belongs there, so that a failed async write can
        never publish a broken checkpoint."""

    @abc.abstractmethod
    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        ...

    def commit(self, tag: str) -> bool:
        """Flush / finalize ``tag`` (reference commit())."""
        return True

    def makedirs(self, path, exist_ok=True):
        os.makedirs(path, exist_ok=exist_ok)


# ------------------------------------------------------------------ trees
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tree_items(tree, path=()):
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order and naming: dict
    keys sorted, sequence indices, NamedTuple field names; None is an empty
    subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _tree_items(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, path + (str(i),))
    else:
        yield path, tree


def _tree_rebuild(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_rebuild(v, fn, path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_tree_rebuild(getattr(tree, n), fn, path + (n,))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_rebuild(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _to_host(leaf, copy: bool = False):
    """A leaf as a host array: tensors as CPU tensors (a copy when asked or
    when the tensor is on a device), numpy arrays as they are, host scalars
    as the reference's device scalars (int32, float32, bool)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.to("cpu", copy=True) if copy or t.device.type != "cpu" else t
    if isinstance(leaf, np.ndarray):
        return np.array(leaf, copy=True) if copy else leaf
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf, dtype=np.bool_)
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, dtype=np.int32)
    if isinstance(leaf, (float, np.floating)):
        return np.asarray(leaf, dtype=np.float32)
    return np.asarray(leaf)


def _flatten_state(tree, prefix="", copy: bool = False) -> Dict[str, Any]:
    """Flatten a tree into path-keyed host arrays ('a/b/0/c' keys, the
    reference's)."""
    return {prefix + "/".join(path): _to_host(leaf, copy)
            for path, leaf in _tree_items(tree)}


def _like(arr, leaf):
    """``arr`` (a host array) in the type of the template ``leaf``: a tensor
    on the leaf's device in its dtype, or a host scalar of its kind."""
    if isinstance(leaf, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint array of shape {tuple(t.shape)} "
                             f"for a {tuple(leaf.shape)} leaf")
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, bool):
        return bool(arr)
    if isinstance(leaf, int):
        return int(arr)
    if isinstance(leaf, float):
        return float(arr)
    return arr


def _unflatten_into(tree_like, flat: Dict[str, Any], strict: bool = True):
    """``tree_like``'s structure with its leaves taken from the path-keyed
    ``flat`` (moved onto each template leaf's device, in its dtype); leaves
    absent from ``flat`` keep the template's value and are listed as
    missing (a KeyError when ``strict``)."""
    missing = []

    def take(path, leaf):
        key = "/".join(path)
        if key in flat:
            return _like(flat[key], leaf)
        missing.append(key)
        return leaf

    out = _tree_rebuild(tree_like, take)
    if missing and strict:
        raise KeyError(f"checkpoint missing keys: {missing[:10]}"
                       f"{'...' if len(missing) > 10 else ''}")
    return out, missing


def nest_flat(flat: Dict[str, Any]) -> Dict[str, Any]:
    """A path-keyed dict as the nested dict its '/' paths describe."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        *heads, last = key.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = val
    return out


# ---------------------------------------------------------- stored form
def _stored(key: str, arr) -> Tuple[str, np.ndarray]:
    """The npz entry of one host array: 16-bit floats as uint16 bits under
    ``@bf16`` / ``@f16``, the rest as numpy arrays."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            return key + "@bf16", arr.contiguous().view(torch.int16).numpy().view(np.uint16)
        arr = arr.contiguous().numpy()
    if arr.dtype == np.float16:
        return key + "@f16", arr.view(np.uint16)
    return key, arr


def _from_stored(key: str, arr: np.ndarray):
    """Inverse of :func:`_stored`: ``(key, tensor)``."""
    if key.endswith("@bf16"):
        return key[:-5], torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if key.endswith("@f16"):
        return key[:-4], torch.from_numpy(arr.view(np.float16))
    return key, torch.from_numpy(arr)


def _array_checksum(arr: np.ndarray) -> Dict[str, Any]:
    """Per-array integrity record over the *stored* representation."""
    return {"crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF,
            "dtype": str(arr.dtype),
            "shape": list(arr.shape)}


def _build_manifest(stored: Dict[str, np.ndarray]) -> Dict[str, Any]:
    return {"version": MANIFEST_VERSION,
            "arrays": {k: _array_checksum(v) for k, v in stored.items()}}


def _verify_manifest(manifest: Dict[str, Any],
                     stored: Dict[str, np.ndarray]) -> Tuple[bool, str]:
    """Check ``stored`` arrays against ``manifest``; returns (ok, reason)."""
    expected = manifest.get("arrays", {})
    missing = sorted(set(expected) - set(stored))
    extra = sorted(set(stored) - set(expected))
    if missing or extra:
        return False, (f"array set mismatch (missing {missing[:5]}, "
                       f"unexpected {extra[:5]})")
    bad = []
    for key, rec in expected.items():
        got = _array_checksum(stored[key])
        if got != rec:
            bad.append(f"{key} (expected {rec}, got {got})")
    if bad:
        return False, f"checksum mismatch: {'; '.join(bad[:3])}"
    return True, "ok"


def _read_npz(path: str):
    """``(stored arrays, meta)`` of a state file; raises what np.load or
    the JSON parse raises."""
    data = fs.retry_io(lambda: np.load(path, allow_pickle=False),
                       description=f"open {path}")
    stored = {k: data[k] for k in data.files if k != "__meta__"}
    meta = json.loads(str(data["__meta__"])) if "__meta__" in data.files else {}
    return stored, meta


def verify_checkpoint(path: str, require_manifest: bool = True) -> Tuple[bool, str]:
    """Standalone integrity check of a native ``state.npz``: readable zip,
    manifest present, every array's crc32/dtype/shape matches. Never raises:
    returns ``(ok, reason)`` so auto-resume can log *why* a tag was skipped."""
    if not os.path.exists(path):
        return False, "missing state file"
    try:
        stored, meta = _read_npz(path)
    except Exception as e:  # truncated zip, bad header, I/O error, ...
        return False, f"unreadable ({type(e).__name__}: {e})"
    manifest = meta.get(MANIFEST_KEY)
    if manifest is None:
        if require_manifest:
            return False, "no integrity manifest"
        return True, "ok (no manifest; unverified)"
    return _verify_manifest(manifest, stored)


class NativeCheckpointEngine(CheckpointEngine):
    """npz checkpoints of whole (global) arrays keyed by parameter path.

    Durability contract: the npz is streamed to ``path + '.tmp'`` with
    retries and atomically renamed onto ``path``, so a crash mid-save never
    leaves a torn file at the final name. Every stored array's
    crc32/dtype/shape is recorded in a manifest inside ``__meta__`` and
    verified on load. ``load`` returns ``{section: {path: CPU tensor}}``
    plus ``"__meta__"``."""

    def save(self, state_dict: Dict[str, Any], path: str, on_success=None):
        dirname = os.path.dirname(path)
        if dirname:  # bare filename → cwd; os.makedirs("") would raise
            self.makedirs(dirname)
        out = {}
        meta = {}
        n = 0
        for section, tree in state_dict.items():
            if section == "__meta__":
                meta = tree
                continue
            for k, v in _flatten_state(tree, prefix=f"{section}::").items():
                key, arr = _stored(k, v)
                out[key] = arr
                n += 1
        meta = dict(meta)  # don't mutate the caller's meta
        meta[MANIFEST_KEY] = _build_manifest(out)
        # streamed: the serialized zip never exists in host memory
        fs.atomic_stream_write(
            path, lambda f: np.savez(f, __meta__=json.dumps(meta), **out))
        log_dist(f"[native-ckpt] saved {n} arrays to {path}", ranks=[0])
        if on_success is not None:
            on_success()

    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        try:
            stored, meta = _read_npz(path)
        except Exception as e:
            raise CheckpointCorruptionError(
                f"checkpoint {path} is unreadable "
                f"({type(e).__name__}: {e}) — likely a truncated or torn write"
            ) from e
        manifest = meta.get(MANIFEST_KEY)
        if manifest is None:
            logger.warning(f"checkpoint {path} has no integrity manifest; "
                           f"loading unverified (pre-manifest checkpoint?)")
        else:
            ok, reason = _verify_manifest(manifest, stored)
            if not ok:
                raise CheckpointCorruptionError(
                    f"checkpoint {path} failed integrity verification: {reason}")
        out: Dict[str, Any] = {}
        for key, arr in stored.items():
            key, t = _from_stored(key, arr)
            section, sub = key.split("::", 1)
            out.setdefault(section, {})[sub] = t
        out["__meta__"] = meta
        return out


class AsyncCheckpointEngine(CheckpointEngine):
    """Background-thread persistence (the reference's Nebula analog).

    ``save`` snapshots the state to host memory synchronously, as copies,
    so training may update parameters and optimizer state in place right
    after, and hands the file write (plus the caller's ``on_success``
    finalizer, e.g. the 'latest' pointer) to a worker thread. A new
    ``save`` first joins the previous write, which is also where a prior
    write's error surfaces. ``commit`` is non-blocking; ``wait`` joins
    everything and raises one error naming every failed write."""

    def __init__(self, config_params=None, inner: Optional[CheckpointEngine] = None):
        super().__init__(config_params)
        self.inner = inner or NativeCheckpointEngine(config_params)
        self._pending: list = []
        self._errors: list = []

    def save(self, state_dict: Dict[str, Any], path: str, on_success=None):
        self.wait()  # join the previous write; surfaces its errors
        snapshot: Dict[str, Any] = {}
        for section, tree in state_dict.items():
            if section == "__meta__":
                # a deep copy: the caller may mutate nested dicts during
                # the overlapped write
                snapshot[section] = copy.deepcopy(tree)
            else:
                snapshot[section] = _flatten_state(tree, copy=True)

        def write():
            try:
                # pre-flattened sections pass through _flatten_state unchanged
                self.inner.save(snapshot, path, on_success=on_success)
            except Exception as e:  # surfaced at the next save()/wait()/load()
                self._errors.append(e)

        # non-daemon: the interpreter joins outstanding writes at exit, so a
        # save issued as the script's last act is never silently truncated
        t = threading.Thread(target=write, daemon=False)
        t.start()
        self._pending.append(t)

    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        self.wait()
        return self.inner.load(path, map_location)

    def commit(self, tag: str) -> bool:
        # non-blocking: durability is finalized by the worker (on_success)
        return True

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()
        if self._errors:
            errs = list(self._errors)
            self._errors.clear()
            detail = "; ".join(f"{type(e).__name__}: {e}" for e in errs)
            raise RuntimeError(
                f"async checkpoint write failed ({len(errs)} error"
                f"{'s' if len(errs) != 1 else ''}): {detail}") from errs[0]


class OrbaxCheckpointEngine(CheckpointEngine):
    """The reference's Orbax engine writes JAX arrays through Orbax; it has
    no PyTorch counterpart and is refused."""

    def __init__(self, config_params=None):
        raise NotPortedError("OrbaxCheckpointEngine (Orbax, a JAX library) "
                             "is not ported to the PyTorch package; use "
                             "NativeCheckpointEngine or AsyncCheckpointEngine")

    def save(self, state_dict, path, on_success=None):  # pragma: no cover
        raise NotPortedError("OrbaxCheckpointEngine")

    def load(self, path, map_location=None):  # pragma: no cover
        raise NotPortedError("OrbaxCheckpointEngine")
