"""Training anomaly sentinel (port of deepspeed_tpu/runtime/sentinel.py).

Long pretraining runs are dominated not by crashes but by *soft*
failures: loss spikes, nonfinite gradients outside the fp16 loss-scaler
path, and silent data corruption. PaLM (Chowdhery et al., 2022) recovered
from spikes by rewinding to a checkpoint and skipping the offending
batches; MegaScale (Jiang et al., 2024) showed SDC detection plus
automated recovery is what keeps goodput high at scale. This module is the
host-side half of that machinery:

  * :class:`RollingRobustStats` — fixed-window robust (median/MAD) z-score
    over a scalar series. Median/MAD instead of mean/std so a spike cannot
    inflate its own detection threshold.
  * :class:`TrainingSentinel` — classifies each step's (loss, grad-norm,
    overflow-flag) observation into the anomaly taxonomy: ``overflow``
    (fp16 loss-scaler handled it), ``nonfinite`` (NaN/Inf loss or grads —
    on bf16/fp32 the engine's ``check_finite_grads`` guard skipped the
    update), ``spike`` (finite but a robust-z outlier), ``divergence``
    (``divergence_patience`` consecutive spikes).
  * :func:`sdc_audit` — cross-replica checksum agreement: devices holding
    the same logical range of an array are bit-identical by construction,
    so any checksum disagreement is silent data corruption; majority vote
    localizes the deviating device. The port trains on one device, which
    holds the one copy of every leaf: no group has two voters, and the
    audit reads ok (``n_groups`` 0) until the port runs data parallelism.
  * :func:`step_replay_probe` — single-device determinism probe: the same
    step from the same state must produce bit-identical results; a
    mismatch is flaky hardware.

Everything but the probe is host logic over already-fetched scalars — the
engine feeds the sentinel at its check fence, one device-to-host copy for
all the steps since the last fence; the device-side half (the nonfinite
flag) lives in ``runtime/engine.py`` / ``runtime/precision.py``.
"""

from __future__ import annotations

import math
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import _tree_items


class AnomalyClass:
    """Anomaly taxonomy (see module docstring)."""

    OVERFLOW = "overflow"      # fp16 dynamic-loss-scale overflow (handled)
    NONFINITE = "nonfinite"    # NaN/Inf loss or grads outside the scaler
    SPIKE = "spike"            # finite robust-z outlier in loss/grad-norm
    DIVERGENCE = "divergence"  # sustained spikes (patience exceeded)
    SDC = "sdc"                # cross-replica checksum disagreement
    REPLAY = "replay"          # step-replay determinism mismatch

    # classes where the data window is suspect: recovery skips the batches
    # between the rewind target and the anomaly (PaLM-style). SDC/replay
    # are hardware faults — the data is fine, so recovery replays it.
    DATA_CLASSES = (NONFINITE, SPIKE, DIVERGENCE)


class TrainingAnomaly(NamedTuple):
    cls: str
    step: int
    value: float
    zscore: float
    detail: str


class TrainingAnomalyError(RuntimeError):
    """A confirmed training anomaly the engine could not auto-recover from
    (no engine-owned dataloader / checkpoint dir, or ``on_anomaly='raise'``)."""

    def __init__(self, anomaly: TrainingAnomaly, msg: Optional[str] = None):
        self.anomaly = anomaly
        super().__init__(
            msg or f"training anomaly: {anomaly.cls} at step {anomaly.step} "
                   f"(value={anomaly.value:.6g}, z={anomaly.zscore:.2f}): "
                   f"{anomaly.detail}")


class RewindBudgetExceededError(TrainingAnomalyError):
    """The rewind budget (rolling window, ElasticAgent semantics) is spent —
    a persistently poisoned shard or failing host must not livelock the job
    in a rewind loop; fail loudly for the operator / elastic agent."""


class RollingRobustStats:
    """Fixed-window series with robust z-scores: z = 0.6745·(v−median)/MAD.

    The 0.6745 factor makes the MAD a consistent σ estimator under
    normality, so thresholds read in 'sigmas'. The MAD is floored
    (relative to |median|) so a near-constant history cannot turn noise
    into infinite z-scores."""

    def __init__(self, window: int = 64):
        self.values: deque = deque(maxlen=max(int(window), 2))

    def __len__(self) -> int:
        return len(self.values)

    def push(self, v: float) -> None:
        self.values.append(float(v))

    def median_mad(self) -> Tuple[float, float]:
        arr = np.asarray(self.values, dtype=np.float64)
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med)))
        return med, max(mad, 1e-3 * abs(med), 1e-12)

    def zscore(self, v: float) -> float:
        if not self.values:
            return 0.0
        med, mad = self.median_mad()
        return 0.6745 * (float(v) - med) / mad

    def reset(self) -> None:
        self.values.clear()


class TrainingSentinel:
    """Per-step anomaly classifier over (loss, grad-norm, overflow) reads.

    ``observe`` returns a :class:`TrainingAnomaly` for anomalous steps and
    ``None`` for clean ones. Anomalous values are NOT pushed into the
    rolling history (a spike must not raise its own baseline); clean
    values are. ``counts`` accumulates per-class totals for telemetry.
    Host-only: usable from any thread."""

    def __init__(self, *, window: int = 64, min_history: int = 8,
                 spike_zscore: float = 8.0, divergence_patience: int = 4,
                 fp16: bool = False):
        self.loss_stats = RollingRobustStats(window)
        self.norm_stats = RollingRobustStats(window)
        self.min_history = max(int(min_history), 2)
        self.spike_zscore = float(spike_zscore)
        self.divergence_patience = max(int(divergence_patience), 2)
        self.fp16 = fp16
        self.consecutive_spikes = 0
        self.counts: Dict[str, int] = {}

    def _anomaly(self, cls: str, step: int, value: float, z: float,
                 detail: str) -> TrainingAnomaly:
        self.counts[cls] = self.counts.get(cls, 0) + 1
        return TrainingAnomaly(cls, step, float(value), float(z), detail)

    def observe(self, step: int, loss: float, grad_norm: float,
                overflow: bool = False) -> Optional[TrainingAnomaly]:
        loss = float(loss)
        grad_norm = float(grad_norm)
        if overflow:
            if self.fp16:
                # the dynamic loss scaler already skipped the update and
                # halved the scale — classified + counted, not actionable
                return self._anomaly(AnomalyClass.OVERFLOW, step, loss, 0.0,
                                     "fp16 loss-scale overflow")
            return self._anomaly(AnomalyClass.NONFINITE, step, loss, 0.0,
                                 "nonfinite grads (finite-grad guard)")
        if not math.isfinite(loss) or not math.isfinite(grad_norm):
            return self._anomaly(AnomalyClass.NONFINITE, step, loss, 0.0,
                                 f"loss={loss} grad_norm={grad_norm}")
        z_loss = self.loss_stats.zscore(loss)
        z_norm = self.norm_stats.zscore(grad_norm)
        warmed = (len(self.loss_stats) >= self.min_history)
        if warmed and max(z_loss, z_norm) > self.spike_zscore:
            self.consecutive_spikes += 1
            z = max(z_loss, z_norm)
            which = "loss" if z_loss >= z_norm else "grad_norm"
            if self.consecutive_spikes >= self.divergence_patience:
                return self._anomaly(
                    AnomalyClass.DIVERGENCE, step, loss, z,
                    f"{self.consecutive_spikes} consecutive {which} spikes")
            return self._anomaly(AnomalyClass.SPIKE, step, loss, z,
                                 f"{which} robust-z {z:.1f} > "
                                 f"{self.spike_zscore}")
        self.consecutive_spikes = 0
        self.loss_stats.push(loss)
        self.norm_stats.push(grad_norm)
        return None

    def reset(self) -> None:
        """Discard all history — for the CALLER's intentional regime
        changes only (e.g. a scheduled LR jump that legitimately shifts
        the loss distribution). The engine deliberately does NOT call
        this on anomaly rewind: a rewind restores the pre-anomaly regime,
        so the existing history is the correct baseline, and resetting
        would open a min_history blind spot exactly where a widened
        second skip may be needed."""
        self.loss_stats.reset()
        self.norm_stats.reset()
        self.consecutive_spikes = 0


# ------------------------------------------------------------ host bytes
def _host_array(leaf) -> np.ndarray:
    """A leaf's value in host memory, C-contiguous: a tensor copied off its
    device (bf16 and f16 through an int16 view, since numpy has no bf16),
    anything else (the step counters, the loss scale) as its numpy
    scalar."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.view(torch.int16)
        return np.ascontiguousarray(t.cpu().numpy())
    return np.ascontiguousarray(np.asarray(leaf))


def _crc(leaf, value: int = 0) -> int:
    arr = _host_array(leaf)
    return zlib.crc32(arr.reshape(-1).view(np.uint8) if arr.ndim else
                      arr.tobytes(), value)


# --------------------------------------------------------------- SDC audits
class SDCAuditResult(NamedTuple):
    ok: bool
    suspects: Tuple[int, ...]        # device ids, worst offender first
    mismatched_groups: int           # (leaf, shard-index) groups disagreeing
    n_groups: int                    # replica groups compared (>1 copy each)


def _device_id(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else 0


def replica_checksums(tree, min_copies: int = 1
                      ) -> Dict[Tuple[str, Tuple], Dict[int, int]]:
    """Per-replica crc32s: ``(leaf path, index range) -> {device_id: crc}``.

    Devices whose copies cover the same index range of the same array hold
    replicas of that range; their bytes must agree bit-exactly. The port
    keeps each tensor whole on one device, so every group holds one copy
    (the whole range, ``(None, None, None)`` per dimension, as the JAX
    package keys a fully replicated array). Leaves are grouped before any
    is hashed, and a group of fewer than ``min_copies`` copies is left out
    unhashed (the audit, which compares copies, asks for two)."""
    groups: Dict[Tuple[str, Tuple], Dict[int, torch.Tensor]] = {}
    for path, leaf in _tree_items(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        idx = tuple((None, None, None) for _ in leaf.shape)
        groups.setdefault(("/".join(path), idx), {})[_device_id(leaf)] = leaf
    return {key: {dev: _crc(leaf) & 0xFFFFFFFF
                  for dev, leaf in per_dev.items()}
            for key, per_dev in groups.items() if len(per_dev) >= min_copies}


def sdc_audit(tree) -> SDCAuditResult:
    """Cross-replica checksum agreement over ``tree`` (params and/or
    optimizer state). Majority vote per disagreeing group names the
    deviating device(s); a device deviating in the most groups is the
    prime suspect (a real bit-flip corrupts one replica's copy of one
    array — it shows up as exactly that device disagreeing)."""
    groups = replica_checksums(tree, min_copies=2)
    suspect_hits: Dict[int, int] = {}
    mismatched = 0
    compared = 0
    for _, per_dev in groups.items():
        if len(per_dev) < 2:
            continue
        compared += 1
        crcs = list(per_dev.values())
        if len(set(crcs)) == 1:
            continue
        mismatched += 1
        counts: Dict[int, int] = {}
        for c in crcs:
            counts[c] = counts.get(c, 0) + 1
        majority = max(counts, key=lambda c: counts[c])
        for dev, c in per_dev.items():
            if c != majority:
                suspect_hits[dev] = suspect_hits.get(dev, 0) + 1
    suspects = tuple(sorted(suspect_hits, key=lambda d: -suspect_hits[d]))
    return SDCAuditResult(ok=mismatched == 0, suspects=suspects,
                          mismatched_groups=mismatched, n_groups=compared)


# -------------------------------------------------------- step-replay probe
def _tree_digest(tree) -> int:
    """crc32 over every leaf's host bytes — bit-exact equality probe. Each
    leaf's crc32 is taken on its own, in a pool of threads (the copy off
    the device and zlib's crc32 both release the GIL); the digest is the
    crc32 of those values in leaf order."""
    leaves = [leaf for _, leaf in _tree_items(tree)]
    with ThreadPoolExecutor(max_workers=min(8, max(len(leaves), 1))) as pool:
        crcs = list(pool.map(_crc, leaves))
    return zlib.crc32(np.asarray(crcs, dtype=np.uint32).tobytes()) & 0xFFFFFFFF


def clone_tree(tree):
    """``tree`` with every tensor cloned on its own device (dicts, NamedTuples,
    lists and tuples rebuilt; other leaves shared)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def step_replay_probe(step_fn: Callable, state, args: Tuple = ()
                      ) -> Tuple[bool, str]:
    """Run ``step_fn(state, *args)`` twice from bit-identical copies of
    ``state`` and compare the outputs bit-exactly. The same kernels on the
    same inputs are deterministic, so any disagreement is hardware silent
    data corruption (flaky ALU / memory). Each copy is a clone on the
    state's own device: a step that updates its state in place consumes
    the copy, never the live state. Returns ``(ok, detail)``."""
    digests: List[int] = []
    for _ in range(2):
        out = step_fn(clone_tree(state), *args)
        digests.append(_tree_digest(out))
        del out
    ok = digests[0] == digests[1]
    return ok, ("ok" if ok else
                f"replay digests differ: {digests[0]:#010x} vs "
                f"{digests[1]:#010x}")
