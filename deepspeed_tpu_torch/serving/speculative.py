"""Speculative decoding for the port's serving engine (port of
deepspeed_tpu/serving/speculative.py).

Each decode iteration drafts up to ``k`` candidate tokens per slot, scores
all of them in ONE target forward (the verify program,
``InferenceEngine.slot_verify_program`` / ``block_verify_program``) and
keeps each slot's accepted prefix plus one token from the target's own
distribution (Leviathan et al., "Fast Inference from Transformers via
Speculative Decoding"): greedy output is the plain decode's token for
token, sampled output follows the target distribution.

* Drafting: :class:`NgramDrafter` (prompt lookup over the slot's own
  history, host numpy, no model) and :class:`DraftModelDrafter` (a small
  draft model through its own :class:`InferenceEngine`: each round
  re-prefills the last ``draft_window`` history tokens into a draft cache
  the drafter owns and rolls ``k`` greedy tokens forward, one program per
  k-bucket, captured as a CUDA graph on the card).
* Acceptance: :func:`speculative_acceptance`, run on the device inside the
  verify program on the target's ``[B, k+1, V]`` logits. Both drafters
  propose point masses, so the rejection rule is: accept draft ``x`` with
  probability ``p(x)``, and on the first rejection draw from ``p`` with
  ``x`` removed and renormalized. Greedy accepts while the draft equals the
  target argmax and emits the argmax at the first mismatch.
* No KV rollback: the verify writes all ``k + 1`` candidates' K/V, and the
  per-slot length advances over the accepted prefix only; rejected
  entries lie behind the length mask and the next verify block overwrites
  them. Slots reserve ``k_max`` lookahead rows at admission for those
  writes.
* :class:`AdaptiveK`: a per-slot moving average of the acceptance fraction
  picks the draft length from the FIXED ``k_buckets`` set, so every
  verify runs one of the programs built at warm-up.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.programs import GraphProgram
from deepspeed_tpu_torch.serving.errors import EngineConfigError, EngineTypeError


# --------------------------------------------------------------- config
@dataclasses.dataclass
class SpeculativeConfig:
    """Speculative-decoding settings of a :class:`ServingEngine`.

    mode: "ngram" (prompt lookup) or "draft" (a draft model; needs
        ``draft_engine``).
    k_buckets: the fixed set of draft lengths a verify may run at (one
        verify program each); adaptive k moves between them.
    max_ngram/min_ngram: suffix n-gram sizes prompt lookup tries, longest
        first.
    draft_engine: the draft model's InferenceEngine ("draft" mode), on the
        target's device and over the target's vocabulary.
    draft_window: trailing history tokens re-prefilled into the draft model
        each round.
    adaptive: per-slot acceptance tracking that moves k within
        ``k_buckets``; off, every round drafts ``k_buckets[-1]``.
    ema_decay: weight of the past in the acceptance average.
    """

    mode: str = "ngram"
    k_buckets: Sequence[int] = (2, 4, 8)
    max_ngram: int = 3
    min_ngram: int = 1
    draft_engine: Optional[object] = None
    draft_window: int = 64
    adaptive: bool = True
    ema_decay: float = 0.7

    def __post_init__(self):
        if self.mode not in ("ngram", "draft"):
            raise EngineConfigError(f"speculative mode must be 'ngram' or "
                                    f"'draft', got {self.mode!r}")
        self.k_buckets = tuple(sorted({int(k) for k in self.k_buckets}))
        if not self.k_buckets or self.k_buckets[0] < 1:
            raise EngineConfigError(f"k_buckets must be >= 1: {self.k_buckets}")
        if self.mode == "draft" and self.draft_engine is None:
            raise EngineConfigError("speculative mode 'draft' needs a "
                                    "draft_engine (an InferenceEngine over the "
                                    "draft model)")
        if not (self.min_ngram >= 1 and self.max_ngram >= self.min_ngram):
            raise EngineConfigError(f"need 1 <= min_ngram <= max_ngram, got "
                                    f"{self.min_ngram}..{self.max_ngram}")

    @property
    def k_max(self) -> int:
        return self.k_buckets[-1]


def normalize_speculative(spec) -> Optional[SpeculativeConfig]:
    """ServingEngine's ``speculative=``: None/False/"off", a mode string, a
    dict of :class:`SpeculativeConfig` fields, or a config."""
    if spec is None or spec is False or spec == "off":
        return None
    if isinstance(spec, SpeculativeConfig):
        return spec
    if isinstance(spec, str):
        return SpeculativeConfig(mode=spec)
    if isinstance(spec, dict):
        return SpeculativeConfig(**spec)
    raise EngineTypeError(f"speculative= takes None/'off'/mode str/dict/"
                          f"SpeculativeConfig, got {type(spec).__name__}")


def pick_k_bucket(k: int, k_buckets: Sequence[int]) -> int:
    """Smallest verify width (k_buckets ascending) holding ``k`` drafts."""
    for b in k_buckets:
        if k <= b:
            return b
    return k_buckets[-1]


# ----------------------------------------------------------- acceptance
def speculative_acceptance(logits: torch.Tensor, tokens: torch.Tensor,
                           draft_len: torch.Tensor, temp,
                           rng: Optional[torch.Generator], *, do_sample: bool,
                           top_k: int = 0, top_p: float = 1.0,
                           pad_token_id: int = 0):
    """Accept or reject ``k`` point-mass drafts against the target's verify
    logits, on the device (nothing is read on the host).

    logits: ``[B, k+1, V]``: position i is the target's distribution for
        the token after ``tokens[:, i]``.
    tokens: ``[B, k+1]`` int: column 0 the last committed token, columns
        1..k the drafts (pad past each row's ``draft_len``).
    draft_len: ``[B]`` int: real drafts per row (0 = a plain decode step).

    Returns ``(out_tokens [B, k+1] int32, n_emit [B] int32)``: row b emits
    ``out_tokens[b, :n_emit[b]]``, its accepted drafts then one token from
    the target (the bonus on full acceptance, the correction on a
    rejection), so ``1 <= n_emit <= draft_len + 1``.

    Greedy: a draft is accepted while it equals the target argmax (f32,
    first index on ties), and the last token is the argmax there. Sampled:
    ``filter_logits(logits / temp)`` gives p; draft x is accepted when a
    uniform falls below ``p(x)`` and the final token is drawn from p at the
    boundary, with the rejected draft's mass removed on a rejection. The
    ``[B, k]`` uniforms, then the ``[B, V]`` uniforms of the final draw
    (the Gumbel-max rule, as the serving picks), come from ``rng``."""
    b, t, v = logits.shape
    k = t - 1
    dev = logits.device
    cols = torch.arange(t, device=dev)[None, :]                  # [1, k+1]
    logits = logits.float()
    tokens = tokens.to(torch.long)
    draft_len = draft_len.to(torch.long)
    pad = torch.full((), pad_token_id, dtype=torch.int32, device=dev)
    if not do_sample:
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)       # [B, k+1]
        match = ((tokens[:, 1:] == tgt[:, :k])
                 & (cols[:, :k] < draft_len[:, None]))
        n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        out = torch.where(cols <= n_acc[:, None], tgt, pad)
        return out, (n_acc + 1).to(torch.int32)

    from deepspeed_tpu_torch.inference.engine import filter_logits

    probs = torch.softmax(filter_logits(logits / temp, top_k=top_k,
                                        top_p=top_p), dim=-1)
    draft = tokens[:, 1:]                                        # [B, k]
    p_draft = torch.take_along_dim(probs[:, :k], draft[..., None],
                                   dim=-1)[..., 0]               # [B, k]
    u = torch.rand((b, k), generator=rng, device=dev)
    acc = (u < p_draft) & (cols[:, :k] < draft_len[:, None])
    n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)  # [B]
    # the boundary position's distribution: on a rejection with the
    # rejected draft removed, on full acceptance the target's own (the
    # clipped gather is safe: where n_acc == k nothing was rejected)
    row_p = torch.take_along_dim(probs, n_acc[:, None, None], dim=1)[:, 0]
    rejected = n_acc < draft_len
    rej_tok = torch.take_along_dim(draft, n_acc.clamp(max=k - 1)[:, None],
                                   dim=1)[:, 0]
    keep = 1.0 - torch.nn.functional.one_hot(rej_tok, v).to(row_p.dtype)
    adj = torch.where(rejected[:, None], row_p * keep, row_p)
    adj = adj / adj.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    g = torch.rand((b, v), generator=rng, device=dev)
    gumbel = -torch.log(-torch.log(g.clamp_min(torch.finfo(torch.float32).tiny)))
    final = torch.argmax(torch.log(adj.clamp_min(1e-30)) + gumbel,
                         dim=-1).to(torch.int32)
    draft_t = torch.cat([draft.to(torch.int32),
                         pad.expand(b, 1)], dim=1)               # [B, k+1]
    out = torch.where(cols < n_acc[:, None], draft_t,
                      torch.where(cols == n_acc[:, None], final[:, None], pad))
    return out, (n_acc + 1).to(torch.int32)


def pack_emitted(out_tokens: torch.Tensor,
                 n_emit: torch.Tensor) -> torch.Tensor:
    """A verify program's result as one int32 ``[B, k+2]`` tensor: the
    ``[B, k+1]`` emitted tokens, then ``n_emit`` as the last column (the
    layout :func:`verify_to_host` splits)."""
    return torch.cat([out_tokens, n_emit[:, None].to(out_tokens.dtype)],
                     dim=1)


def verify_to_host(packed: torch.Tensor):
    """A verify program's :func:`pack_emitted` result as host numpy
    ``(out_tokens [B, k+1], n_emit [B])``, read in one device-to-host
    copy."""
    host = packed.cpu().numpy()
    return host[:, :-1], host[:, -1]


# -------------------------------------------------------------- drafting
def ngram_propose(history, k: int, *, max_ngram: int = 3,
                  min_ngram: int = 1) -> np.ndarray:
    """Prompt-lookup drafting: the ``k`` tokens that followed the most
    recent earlier occurrence of the history's suffix n-gram, longest
    n-gram first; among the matches, the most recent with a full
    ``k``-token continuation, else the most recent. Returns int32 of length
    <= k (empty: no match)."""
    h = np.asarray(history, np.int64)
    n_hi = min(max_ngram, len(h) - 1)
    for n in range(n_hi, min_ngram - 1, -1):
        suffix = h[len(h) - n:]
        windows = np.lib.stride_tricks.sliding_window_view(h, n)
        # the suffix's own occurrence (the last window) is left out
        starts = np.nonzero((windows[:-1] == suffix[None, :]).all(axis=1))[0]
        if len(starts):
            avail = len(h) - (starts + n)
            full = starts[avail >= k]
            s = int(full[-1] if len(full) else starts[-1]) + n
            cont = h[s:s + k]
            if len(cont):
                return cont.astype(np.int32)
    return np.zeros((0,), np.int32)


class NgramDrafter:
    """Per-slot prompt lookup over the host-side token histories."""

    def __init__(self, config: SpeculativeConfig):
        self.config = config

    def propose(self, histories, want, kb: int):
        """histories: per-slot token histories (None: the slot sits this
        round out); want: ``[num_slots]`` draft-length caps; kb: the verify
        bucket. Returns int32 ``[num_slots, kb]`` drafts and ``[num_slots]``
        lengths."""
        n = len(histories)
        drafts = np.zeros((n, kb), np.int32)
        lens = np.zeros((n,), np.int32)
        for i, hist in enumerate(histories):
            if hist is None or want[i] < 1:
                continue
            prop = ngram_propose(hist, int(want[i]),
                                 max_ngram=self.config.max_ngram,
                                 min_ngram=self.config.min_ngram)
            lens[i] = len(prop)
            drafts[i, :len(prop)] = prop
        return drafts, lens

    def warmup(self) -> None:
        """Nothing to build: the drafting runs on the host."""

    def program_cache_sizes(self) -> Dict[str, int]:
        return {}


class DraftModelDrafter:
    """Greedy drafting by a draft model through its own InferenceEngine,
    all slots at once.

    Each round re-prefills the last ``draft_window`` history tokens of
    every slot into the draft cache and rolls ``kb`` greedy tokens forward
    (``InferenceEngine.slot_draft_program``): nothing persists from round to
    round, so nothing is rolled back on a rejection, and the program's
    shapes never vary (``[slots, window]`` ids and ``[slots]`` lengths, one
    program per k-bucket). The drafter owns the draft cache (``window +
    k_max`` positions, enough for every bucket) and the pinned host and
    device buffers of the per-round window and lengths; on the card each
    program is one CUDA graph, on the draft engine's ``graph_pool``.

    ``device``: the target engine's device; a draft engine elsewhere
    raises."""

    def __init__(self, config: SpeculativeConfig, num_slots: int,
                 pad_token_id: int = 0, device=None):
        self.config = config
        self.engine = config.draft_engine
        self.num_slots = num_slots
        self.pad_token_id = pad_token_id
        self.window = int(config.draft_window)
        if device is not None and (torch.device(self.engine.device)
                                   != torch.device(device)):
            raise EngineConfigError(
                f"the draft engine runs on {self.engine.device}, the target "
                f"on {device}: speculation needs both on one device")
        mcfg = self.engine.module.config
        need = self.window + config.k_max
        if need > mcfg.max_seq_len:
            raise EngineConfigError(
                f"draft_window {self.window} + k_max {config.k_max} "
                f"exceeds the draft model's max_seq_len {mcfg.max_seq_len}")
        dev = self.engine.device
        cache = self.engine.module.init_cache(num_slots, need,
                                              dtype=self.engine.dtype,
                                              device=dev)
        self.k, self.v = cache["k"], cache["v"]
        if torch.device(dev).type == "cuda":
            from deepspeed_tpu_torch.ops.decode_step import supports

            _, _, hkv, s, dh = self.k.shape
            if not supports(mcfg.num_heads, hkv, s, dh, self.k.element_size()):
                raise EngineConfigError(
                    f"the decode kernel does not take the draft cache "
                    f"{tuple(self.k.shape)} with {mcfg.num_heads} query "
                    "heads (ops/decode_step.py supports)")
        pin = torch.device(dev).type == "cuda"
        self._ids_host = torch.zeros((num_slots, self.window),
                                     dtype=torch.int32, pin_memory=pin)
        self._wlen_host = torch.zeros((num_slots,), dtype=torch.int32,
                                      pin_memory=pin)
        self._ids = torch.zeros((num_slots, self.window), dtype=torch.int32,
                                device=dev)
        self._wlen = torch.ones((num_slots,), dtype=torch.int32, device=dev)
        self._programs: Dict[int, GraphProgram] = {}

    def _program(self, kb: int) -> GraphProgram:
        if kb not in self._programs:
            self._programs[kb] = GraphProgram(
                self.engine.slot_draft_program(self.window, self.num_slots, kb),
                self.engine.graph_pool)
        return self._programs[kb]

    def _run(self, kb: int) -> torch.Tensor:
        self._ids.copy_(self._ids_host, non_blocking=True)
        self._wlen.copy_(self._wlen_host, non_blocking=True)
        return self._program(kb)(self.engine.params, self.k, self.v,
                                 self._ids, self._wlen)

    def warmup(self) -> None:
        """Run (on the card: capture) every bucket's draft program once on
        a pad window."""
        self._ids_host.fill_(self.pad_token_id)
        self._wlen_host.fill_(1)
        for kb in self.config.k_buckets:
            self._run(kb)

    def propose(self, histories, want, kb: int):
        """As :meth:`NgramDrafter.propose`; every live slot gets
        ``min(want, kb)`` drafts. The draft tokens come back in one copy."""
        # the previous round's read of its drafts synchronized the stream,
        # so the pinned host buffers are free to write
        ids, wlen = self._ids_host.numpy(), self._wlen_host.numpy()
        ids.fill(self.pad_token_id)
        wlen.fill(1)                    # >= 1: the first pick's gather
        for i, hist in enumerate(histories):
            if hist is None:
                continue
            tail = np.asarray(hist[-self.window:], np.int32)
            ids[i, :len(tail)] = tail
            wlen[i] = len(tail)
        drafts = self._run(kb).cpu().numpy()
        lens = np.minimum(np.asarray(want, np.int32), kb)
        lens = np.where([h is not None for h in histories], lens, 0)
        return drafts.astype(np.int32), lens.astype(np.int32)

    def program_cache_sizes(self) -> Dict[str, int]:
        return {f"draft_{kb}": fn._cache_size()
                for kb, fn in self._programs.items()}


# ------------------------------------------------------------ adaptive k
class AdaptiveK:
    """Per-slot acceptance average -> draft length, within the fixed
    ``k_buckets``. After each verify the slot's acceptance fraction
    ``n_accepted / draft_len`` folds into the average; the desired k is the
    bucket at the average's position in [0, 1]. Slots start at 1.0 (k_max)
    and a run of rejections walks k down to ``k_buckets[0]``."""

    def __init__(self, config: SpeculativeConfig, num_slots: int):
        self.buckets = config.k_buckets
        self.decay = float(config.ema_decay)
        self.ema = np.ones((num_slots,), np.float64)

    def reset_slot(self, slot: int) -> None:
        self.ema[slot] = 1.0

    def update(self, slot: int, n_accepted: int, draft_len: int) -> None:
        if draft_len < 1:
            return                      # a plain step: no signal
        frac = n_accepted / draft_len
        self.ema[slot] = self.decay * self.ema[slot] + \
            (1.0 - self.decay) * frac

    def desired_k(self, slot: int) -> int:
        i = min(int(self.ema[slot] * len(self.buckets)),
                len(self.buckets) - 1)
        return self.buckets[i]
