"""Engine checkpoint save/load (port of
deepspeed_tpu/runtime/checkpoint_engine/engine.py), on one device.

Layout under ``save_dir``, the reference's:
    latest                       — text file holding the newest tag
    <tag>/state.npz              — param / optimizer / scaler arrays (path-keyed)
    <tag>/client_state.json      — counters, lr-scheduler state, user state
The arrays are whole and keyed by parameter path (checkpoint_engine.py), so
a tag written by the reference's engine loads here and one written here
loads into the reference's. On load, every array moves onto the engine's
device in the dtype of the engine's own leaf.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    MANIFEST_KEY,
    CheckpointCorruptionError,
    NativeCheckpointEngine,
    _flatten_state,
    _from_stored,
    _stored,
    _unflatten_into,
    nest_flat,
    verify_checkpoint,
)
from deepspeed_tpu_torch.telemetry import record_event
from deepspeed_tpu_torch.utils import fs
from deepspeed_tpu_torch.utils.logging import log_dist, logger

# the reference's mesh (five axes) on one device, as client_state.json
# records it
_MESH_SHAPE = [1, 1, 1, 1, 1]


def _tag_for(engine, tag: Optional[str]) -> str:
    return tag if tag is not None else f"global_step{engine.global_steps}"


def save_engine_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                           client_state: Optional[dict] = None,
                           save_latest: bool = True, checkpoint_engine=None):
    # the reference's tag agreement across processes: one process here
    tag = _tag_for(engine, tag)
    ckpt_engine = checkpoint_engine or NativeCheckpointEngine()
    ckpt_engine.create(tag)
    os.makedirs(os.path.join(save_dir, tag), exist_ok=True)  # before any
    # sync sidecar writes: an async engine creates it only in its worker
    path = os.path.join(save_dir, tag, "state.npz")
    state = engine.state
    state_dict = {
        "params": state.params,
        "opt_state": state.opt_state,
        "scaler": state.scaler,
        "__meta__": {"global_step": int(state.global_step)},
    }
    # deterministic data-pipeline resume: the (seed, epoch, in-epoch
    # offset) triple rides in __meta__; not for an external data_sampler,
    # whose order may not replay across a restart
    dataloader = getattr(engine, "training_dataloader", None)
    if dataloader is not None and hasattr(dataloader, "state_dict") and \
            getattr(dataloader, "supports_deterministic_resume",
                    lambda: True)():
        state_dict["__meta__"]["dataloader"] = dataloader.state_dict()

    cs = {
        "global_steps": engine.global_steps,
        "micro_steps": engine.micro_steps,
        "skipped_steps": engine.skipped_steps,
        "zero_stage": engine.zero_stage,
        "dtype": str(engine.compute_dtype).replace("torch.", ""),
        "lr_scheduler": engine.lr_scheduler.state_dict() if engine.lr_scheduler else None,
        "client_state": client_state or {},
        "mesh_shape": list(_MESH_SHAPE),
    }

    def finalize():
        """Runs only after the state is durably written (an async engine
        must never publish 'latest' for a failed write); both sidecars are
        published atomically."""
        fs.atomic_write_text(os.path.join(save_dir, tag, "client_state.json"),
                             json.dumps(cs, indent=2))
        if save_latest:
            fs.atomic_write_text(os.path.join(save_dir, "latest"), tag)

    ckpt_engine.save(state_dict, path, on_success=finalize)
    ckpt_engine.commit(tag)
    record_event("checkpoint/saves", tag=tag, global_step=cs["global_steps"])
    log_dist(f"saved checkpoint {tag} to {save_dir}", ranks=[0])
    return True


def list_checkpoint_tags(load_dir: str):
    """Tag directories under ``load_dir`` that look like checkpoints (the
    native npz, or the reference's Orbax layout), newest state file first."""
    try:
        names = os.listdir(load_dir)
    except OSError:
        return []
    found = []
    for name in names:
        tag_dir = os.path.join(load_dir, name)
        if not os.path.isdir(tag_dir):
            continue
        for probe in ("state.npz", "state.npz.orbax", "state.npz.meta.json"):
            p = os.path.join(tag_dir, probe)
            try:
                found.append((os.path.getmtime(p), name))
                break
            except OSError:  # vanished between listdir and stat
                continue
    return [name for _, name in sorted(found, reverse=True)]


def validate_checkpoint_tag(load_dir: str, tag: str):
    """Structural + integrity validation of one tag; ``(ok, reason)``."""
    npz = os.path.join(load_dir, tag, "state.npz")
    if os.path.exists(npz):
        return verify_checkpoint(npz, require_manifest=True)
    if os.path.exists(npz + ".orbax"):
        return False, "Orbax checkpoint (not readable by the PyTorch package)"
    return False, "missing state.npz"


_NO_MANIFEST = "no integrity manifest"


def _read_client_state(load_dir: str, tag: str):
    """A tag's parsed client_state.json; None when absent or unreadable."""
    cs_path = os.path.join(load_dir, tag, "client_state.json")
    if not os.path.exists(cs_path):
        return None
    try:
        return json.loads(fs.read_bytes_with_retry(cs_path).decode())
    except Exception as e:
        logger.warning(f"client_state.json for tag '{tag}' unreadable "
                       f"({type(e).__name__}: {e}); resuming from "
                       f"checkpoint meta only")
        return None


def _read_latest_tag(load_dir: str):
    """Best-effort read of the 'latest' pointer; None when absent or
    unreadable (the candidate scan still finds every tag on disk)."""
    latest_path = os.path.join(load_dir, "latest")
    if not os.path.exists(latest_path):
        return None
    try:
        return fs.read_bytes_with_retry(latest_path).decode().strip() or None
    except (OSError, UnicodeDecodeError) as e:
        logger.warning(f"auto-resume: 'latest' pointer unreadable "
                       f"({type(e).__name__}: {e}); scanning candidate tags")
        return None


def _try_load_candidate(load_dir: str, tag: str, ckpt_engine):
    """One verified load attempt of ``tag``: ``(loaded, client_state,
    reason)`` with reason 'ok' or the no-manifest marker, else ``(None,
    None, why)``. A present client_state.json must parse."""
    npz = os.path.join(load_dir, tag, "state.npz")
    if not os.path.exists(npz):
        return None, None, "missing state.npz"
    try:
        loaded = ckpt_engine.load(npz)  # native engines checksum-verify here
    except Exception as e:
        return None, None, f"unloadable ({type(e).__name__}: {e})"
    cs = None
    cs_path = os.path.join(load_dir, tag, "client_state.json")
    if os.path.exists(cs_path):
        try:
            cs = json.loads(fs.read_bytes_with_retry(cs_path).decode())
        except Exception as e:
            return None, None, f"corrupt client_state.json ({type(e).__name__}: {e})"
    if MANIFEST_KEY not in loaded.get("__meta__", {}):
        return loaded, cs, _NO_MANIFEST
    return loaded, cs, "ok"


def _auto_resume_load(load_dir: str, ckpt_engine):
    """Load the newest *valid* checkpoint under ``load_dir``: the 'latest'
    pointer first, then every other candidate tag newest first. Returns
    ``(tag, loaded, client_state)``; ``(None, None, None)`` when there is
    no candidate. Manifest-verified candidates win; failing those, the
    newest readable pre-manifest checkpoint is taken with a warning. Raises
    :class:`CheckpointCorruptionError` when candidates exist but none
    loads."""
    latest_tag = _read_latest_tag(load_dir)
    candidates = list_checkpoint_tags(load_dir)
    ordered = ([latest_tag] if latest_tag else []) + \
        [t for t in candidates if t != latest_tag]
    if not ordered:
        return None, None, None
    skipped = []
    legacy = None  # newest readable pre-manifest candidate, the last resort
    for t in ordered:
        loaded, cs, reason = _try_load_candidate(load_dir, t, ckpt_engine)
        if loaded is not None and reason == "ok":
            if skipped or t != latest_tag:
                record_event("checkpoint/corruption_fallbacks",
                             fallback_tag=t, latest=latest_tag,
                             skipped=[f"{s}: {r}" for s, r in skipped])
                logger.warning(
                    f"auto-resume: falling back to checkpoint '{t}' "
                    f"(latest='{latest_tag}'); skipped: "
                    + "; ".join(f"{s}: {r}" for s, r in skipped))
            return t, loaded, cs
        if loaded is not None and legacy is None:
            legacy = (t, loaded, cs)
        skipped.append((t, reason))
        logger.warning(f"auto-resume: skipping checkpoint '{t}': {reason}")
    if legacy is not None:
        t, loaded, cs = legacy
        if skipped and skipped != [(t, _NO_MANIFEST)]:
            record_event("checkpoint/corruption_fallbacks",
                         fallback_tag=t, latest=latest_tag, legacy=True)
        logger.warning(
            f"auto-resume: no manifest-verified checkpoint under {load_dir}; "
            f"resuming from pre-manifest checkpoint '{t}' (unverified)")
        return t, loaded, cs
    record_event("checkpoint/load_failures", latest=latest_tag,
                 rejected=[f"{t}: {r}" for t, r in skipped])
    raise CheckpointCorruptionError(
        f"no valid checkpoint under {load_dir} "
        f"(latest='{latest_tag}'); candidates rejected: "
        + "; ".join(f"{t}: {r}" for t, r in skipped))


def load_engine_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                           load_optimizer_states: bool = True,
                           load_lr_scheduler_states: bool = True,
                           load_module_only: bool = False,
                           checkpoint_engine=None):
    ckpt_engine = checkpoint_engine or NativeCheckpointEngine()
    if tag is None:
        tag, loaded, cs = _auto_resume_load(load_dir, ckpt_engine)
        if tag is None:
            logger.warning(f"no checkpoint found under {load_dir}; nothing loaded")
            return None, {}
    else:
        base = os.path.join(load_dir, tag, "state.npz")
        if not os.path.exists(base):
            latest = _read_latest_tag(load_dir) or "<absent>"
            avail = list_checkpoint_tags(load_dir)
            raise FileNotFoundError(
                f"checkpoint tag '{tag}' not found under {load_dir}: no "
                f"{base}; 'latest' points to '{latest}'; available tags: "
                f"{avail if avail else 'none'}")
        loaded = ckpt_engine.load(base)
        cs = _read_client_state(load_dir, tag)

    state = engine.state
    params, _ = _unflatten_into(state.params, loaded.get("params", {}))
    opt_state = state.opt_state
    if load_optimizer_states and not load_module_only and "opt_state" in loaded:
        opt_state, _ = _unflatten_into(state.opt_state, loaded["opt_state"],
                                       strict=False)
    scaler = state.scaler
    if "scaler" in loaded and not load_module_only:
        scaler, _ = _unflatten_into(state.scaler, loaded["scaler"], strict=False)

    meta = loaded.get("__meta__", {})
    gstep = int(meta.get("global_step", 0))
    engine.state = state._replace(params=params, opt_state=opt_state,
                                  scaler=scaler, global_step=gstep)
    # host counters follow even without client_state.json, so the LR
    # schedule resumes from the right step
    engine.global_steps = gstep
    # restore the data-pipeline position when the saved state describes
    # THIS pipeline (identity fields match); the live iterator is dropped
    # so the next pull honours it
    dataloader = getattr(engine, "training_dataloader", None)
    dl_state = meta.get("dataloader")
    if dataloader is not None and dl_state and \
            hasattr(dataloader, "load_state_dict"):
        matches = getattr(dataloader, "resume_state_matches",
                          lambda s: True)(dl_state)
        resumable = getattr(dataloader, "supports_deterministic_resume",
                            lambda: True)()
        if matches and resumable:
            dataloader.load_state_dict(dl_state)
            engine._train_iter = None
        else:
            logger.warning(
                "checkpoint dataloader state not restored (%s); the data "
                "pipeline starts from its current position",
                "external data_sampler" if not resumable
                else "identity mismatch — different dataset/batching")

    client_state = {}
    if cs is not None:
        engine.global_steps = cs.get("global_steps", gstep)
        engine.micro_steps = cs.get("micro_steps", 0)
        engine.skipped_steps = cs.get("skipped_steps", 0)
        if load_lr_scheduler_states and engine.lr_scheduler and cs.get("lr_scheduler"):
            engine.lr_scheduler.load_state_dict(cs["lr_scheduler"])
        client_state = cs.get("client_state", {})
    record_event("checkpoint/loads", tag=tag, global_step=gstep)
    log_dist(f"loaded checkpoint {tag} from {load_dir} onto {engine.device}",
             ranks=[0])
    return os.path.join(load_dir, tag), client_state


def load_params_for_inference(load_dir: str, template=None,
                              tag: Optional[str] = None):
    """Load ONLY the model params of an engine checkpoint: re-keyed onto
    ``template``'s structure (its devices and dtypes), or, with no
    template, as the nested dict of CPU tensors the keys describe."""
    ckpt_engine = NativeCheckpointEngine()
    if tag is None:
        tag, loaded, _ = _auto_resume_load(load_dir, ckpt_engine)
        if tag is None:
            raise FileNotFoundError(f"no checkpoint found under {load_dir}")
    else:
        loaded = ckpt_engine.load(os.path.join(load_dir, tag, "state.npz"))
    flat = loaded.get("params", {})
    if template is None:
        return nest_flat(flat)
    params, _ = _unflatten_into(template, flat)
    return params


def save_16bit_model(engine, save_dir: str, save_filename: str = "model_weights.npz"):
    """Consolidated 16-bit weights for serving (reference save_16bit_model):
    every float parameter as bf16 bits under ``<path>@bf16``, the rest as
    they are."""
    os.makedirs(save_dir, exist_ok=True)
    out = {}
    for k, v in _flatten_state(engine.state.params).items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            v = v.to(torch.bfloat16)
        key, arr = _stored(k, v)
        out[key] = arr
    if not save_filename.endswith(".npz"):
        save_filename += ".npz"  # np.savez appends it anyway; keep path truthful
    np.savez(os.path.join(save_dir, save_filename), **out)
    return os.path.join(save_dir, save_filename)


def load_16bit_model(path: str):
    """``{path: CPU tensor}`` of a 16-bit model file (bf16 where stored so)."""
    data = np.load(path)
    return dict(_from_stored(k, data[k]) for k in data.files)


def zero_to_fp32(checkpoint_dir: str, output_file: str, tag: Optional[str] = None):
    """Full fp32 weights of a checkpoint (reference utils/zero_to_fp32.py):
    the stored arrays are already whole, so this re-keys and casts."""
    if tag is None:
        with open(os.path.join(checkpoint_dir, "latest")) as f:
            tag = f.read().strip()
    loaded = NativeCheckpointEngine().load(os.path.join(checkpoint_dir, tag, "state.npz"))
    params = loaded.get("params", {})
    np.savez(output_file, **{k: (v.float() if v.is_floating_point() else v).numpy()
                             for k, v in params.items()})
    return output_file
