"""Inference engine of the PyTorch port (port of the slot-serving half of
deepspeed_tpu/inference/engine.py).

What it owns: the parameters on the device in the serving dtype (random,
from ``config.seed``, or handed in — e.g. from the weight bridge), optional
weight-only int8 quantization of the stacked block matmul weights
(per-layer, per-output-column scales ``[L, 1, E]``, as
``_quantize_block_weights``), the no-cache forward, and the two programs the
continuous-batching server drives: the slot-insert prefill and the
per-slot decode step. JAX ``jit`` programs become plain closures; the
persistent slot cache is updated in place instead of being donated.
Selection is greedy (argmax, first index on ties); sampling is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.compression.quantize import quantize_int8
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.ops.attention import write_slot_prefix
from deepspeed_tpu_torch.utils.logging import log_dist


def _is_quantizable(shape) -> bool:
    """Stacked ``[L, in, out]`` block matmul weights large enough to be
    worth quantizing (the JAX engine's predicate)."""
    return len(shape) == 3 and min(shape[1:]) >= 16


def greedy_pick(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim in f32, int32 (first index on ties)."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


class InferenceEngine:
    """Serve a :class:`~deepspeed_tpu_torch.models.llama.LlamaModel` on one
    device (the card unless ``device="cpu"`` is asked for)."""

    def __init__(self, model, config=None, *, params=None, device=None):
        if not isinstance(config, DeepSpeedInferenceConfig):
            config = DeepSpeedInferenceConfig.from_dict(config or {})
        self._config = config
        self.accelerator = get_accelerator(device)
        self.device = self.accelerator.device()
        self.dtype = config.torch_dtype()
        self.weight_quant = bool(config.quant.enabled)
        if self.dtype == torch.int8:
            self.weight_quant, self.dtype = True, torch.bfloat16
        if self.weight_quant:
            if config.quant.bits != 8:
                raise ValueError("weight quantization supports bits=8 only "
                                 f"(got {config.quant.bits})")
            if not getattr(model, "supports_weight_quant", False):
                raise ValueError(f"int8 weight quantization requested but "
                                 f"{type(model).__name__} does not route its "
                                 "block matmuls through models/base.qdot")
        model.compute_dtype = self.dtype
        self.module = model
        quant = _is_quantizable if self.weight_quant else None
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            self.params = model.init(gen, device=self.device, dtype=self.dtype,
                                     quantize=quant)
        else:
            self.params = self._adopt(params, in_blocks=False)
        self._programs: Dict[Tuple, Callable] = {}
        log_dist(f"InferenceEngine: dtype={self.dtype} int8={self.weight_quant} "
                 f"device={self.device} max_tokens={config.max_tokens}",
                 ranks=[0])

    def _adopt(self, node, in_blocks: bool):
        """Move handed-in params to the device in the serving dtype; with
        weight quantization, float block matmul weights are quantized here
        (int8 dicts pass through)."""
        if isinstance(node, dict):
            if "__q__" in node:
                return {"__q__": node["__q__"].to(self.device, torch.int8),
                        "__scale__": node["__scale__"].to(self.device,
                                                          torch.float32)}
            return {k: self._adopt(v, in_blocks or k == "blocks")
                    for k, v in node.items()}
        t = node.to(self.device)
        if t.is_floating_point():
            t = t.to(self.dtype)
            if self.weight_quant and in_blocks and _is_quantizable(t.shape):
                q, s = quantize_int8(t, reduce_dims=(1,))
                return {"__q__": q, "__scale__": s}
        return t

    @property
    def config(self) -> DeepSpeedInferenceConfig:
        return self._config

    # ----------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, input_ids) -> torch.Tensor:
        """Full no-cache forward -> logits ``[B, T, V]``."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        hidden = self.module.forward_hidden(self.params, ids)
        return self.module.logits(self.params, hidden)

    __call__ = forward

    # ----------------------------------------- continuous-batching programs
    def slot_prefill_program(self, bucket_len: int, num_slots: int,
                             max_len: int) -> Callable:
        """Slot-insert prefill for the serving runtime: run ONE request's
        bucket-padded prompt through a fresh bucket-sized cache, copy the
        prefix K/V into slot ``slot`` of the persistent cache, set the slot's
        valid length, and pick the first token from the logits at the TRUE
        last prompt position (the pad tokens behind it are causally
        invisible).

        Signature: ``(params, k_slots, v_slots, lengths, ids[1, bucket],
        slot, length) -> (k_slots, v_slots, lengths, first_token[])``; the
        slot tensors are updated in place."""
        key = ("slot_pf", bucket_len, num_slots, max_len)
        if key not in self._programs:
            model, dtype = self.module, self.dtype

            @torch.no_grad()
            def prefill(params, k_slots, v_slots, lengths, ids, slot, length):
                cache = model.init_cache(1, bucket_len, dtype=dtype,
                                         device=k_slots.device)
                logits, cache = model.forward_with_cache(params, ids, cache)
                write_slot_prefix(k_slots, v_slots, cache["k"], cache["v"],
                                  int(slot))
                lengths[int(slot)] = int(length)
                last = logits[:, int(length) - 1]                 # [1, V]
                return k_slots, v_slots, lengths, greedy_pick(last)[0]

            self._programs[key] = prefill
        return self._programs[key]

    def slot_decode_program(self, num_slots: int, max_len: int, *,
                            pad_token_id: int = 0) -> Callable:
        """Persistent-cache decode step: ONE token for every slot against the
        slot cache with the per-slot length vector (read on the device by the
        fused decode kernel; the host never waits on it). Inactive slots keep
        their length and emit ``pad_token_id``; their masked garbage write
        lands at their stale length (dropped if that is past the cache) and
        is overwritten by the next prefill into the slot.

        Signature: ``(params, k_slots, v_slots, lengths[B], tokens[B],
        active[B] bool) -> (k_slots, v_slots, lengths, next_tokens[B])``."""
        key = ("slot_dec", num_slots, max_len, pad_token_id)
        if key not in self._programs:
            model = self.module

            @torch.no_grad()
            def decode(params, k_slots, v_slots, lengths, tokens, active):
                cache = {"k": k_slots, "v": v_slots, "index": lengths}
                logits, cache = model.forward_with_cache(
                    params, tokens[:, None].long(), cache)
                pad = torch.full_like(tokens, pad_token_id)
                nxt = torch.where(active, greedy_pick(logits[:, -1]), pad)
                lengths = torch.where(active, lengths + 1, lengths)
                return cache["k"], cache["v"], lengths, nxt

            self._programs[key] = decode
        return self._programs[key]
