"""Inference engine of the PyTorch port (port of deepspeed_tpu/inference/
engine.py: ``generate`` and the serving programs).

What it owns: the parameters on the device in the serving dtype (random,
from ``config.seed``, or handed in — e.g. from the weight bridge), optional
weight-only int8 quantization of the stacked block matmul weights
(per-layer, per-output-column scales ``[L, 1, E]``, as
``_quantize_block_weights``) and of a tied embedding
(``quant.quantize_embedding``, one scale per vocab row), the no-cache
forward, ``generate`` (a prefill and a decode loop over a stacked cache
padded to a multiple of 128, with greedy, temperature / top-k / top-p
sampling from a ``torch.Generator``, and the EOS early exit), and the
programs the continuous-batching server drives: the slot-paged prefill and
decode step, and their block-paged analogs (suffix prefill, decode through
the block table, the copy-on-write block copy). JAX ``jit`` programs become
plain closures; the caches are updated in place instead of being donated.
The serving programs pick greedily (argmax, first index on ties); their
sampling is not ported.
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


def filter_logits(logits: torch.Tensor, *, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Sampling filter of the reference (HF's TopKLogitsWarper then
    TopPLogitsWarper): keep the ``top_k`` largest logits, then the smallest
    prefix of the descending-sorted distribution whose cumulative
    probability reaches ``top_p`` (an exclusive cumsum, so the token that
    crosses it is kept, and always at least one); the rest become -inf.
    Value ties at either boundary are all kept."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        kth = torch.where(keep, srt, torch.full_like(srt, float("inf")))
        kth = kth.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return logits


class InferenceEngine:
    """Serve a :class:`~deepspeed_tpu_torch.models.llama.LlamaModel` or a
    :class:`~deepspeed_tpu_torch.models.gpt2.GPT2Model` on one device (the
    card unless ``device="cpu"`` is asked for)."""

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
        elif config.quant.quantize_embedding:
            raise ValueError(
                "quant.quantize_embedding requires weight quantization "
                "(quant.enabled=true or dtype='int8'): the tied-embedding "
                "int8 path rides the weight-quant initialization")
        model.compute_dtype = self.dtype
        self.module = model
        quant = _is_quantizable if self.weight_quant else None
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            self.params = model.init(gen, device=self.device, dtype=self.dtype,
                                     quantize=quant)
        else:
            self.params = self._adopt(params, in_blocks=False)
        if self.weight_quant:
            self.params = self._maybe_quantize_embedding(self.params)
        self._programs: Dict[Tuple, Callable] = {}
        # generate(seed=None) advances this one; seed=k draws from a fresh
        # generator seeded with k
        self._gen_rng = torch.Generator(device=self.device).manual_seed(
            config.seed)
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

    def _maybe_quantize_embedding(self, params):
        """int8 tied embedding (``quant.quantize_embedding``): one scale per
        vocab row serves both the gather (models/base.embed_tokens, an exact
        per-row dequantization) and the tied LM head (base.tied_logits, the
        scale on the logit column). The model must route its tied table
        through those helpers (``supports_embedding_quant``)."""
        if not self._config.quant.quantize_embedding:
            return params
        if not getattr(self.module, "supports_embedding_quant", False):
            raise ValueError(
                f"quant.quantize_embedding requested but "
                f"{type(self.module).__name__} does not route its tied "
                "embedding through models/base.embed_tokens/tied_logits")
        if not getattr(self.module.config, "tie_embeddings", True):
            raise ValueError("quant.quantize_embedding targets the TIED "
                             "embedding; this model unties wte from its "
                             "lm_head")
        if isinstance(params["wte"], dict):
            return params                       # handed in quantized
        q, s = quantize_int8(params.pop("wte"), per_channel_axis=0)   # [V, 1]
        params["wte"] = {"__q__": q, "__scale__": s}
        log_dist("weight-only int8: quantized tied embedding/lm-head "
                 "(per-vocab-row scales)", ranks=[0])
        return params

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

    # ---------------------------------------------------------- generate
    def generate(self, input_ids, max_new_tokens: int = 32, *,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                 seed: Optional[int] = None) -> torch.Tensor:
        """Autoregressive generation: one prefill, then ``max_new_tokens -
        1`` single-token decode steps over a stacked cache. Greedy, or
        sampling with ``temperature``, ``top_k`` and ``top_p``
        (:func:`filter_logits`); ``seed`` None advances the engine's
        generator (seeded from ``config.seed``), an int draws from a fresh
        one. With ``eos_token_id`` a row emits ``pad_token_id`` after its
        EOS, and the loop stops once every row has emitted EOS.

        ``input_ids`` ``[B, T]`` (one prompt length per call). Returns the
        ``[B, T + max_new_tokens]`` int64 token ids, prompt included, on the
        CPU."""
        ids = torch.as_tensor(input_ids).cpu().long()
        assert ids.ndim == 2, "generate expects [batch, seq]"
        if max_new_tokens < 1:
            raise ValueError(f"generate: max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if max_new_tokens < self._config.min_out_tokens:
            raise RuntimeError(
                f"generate: max_new_tokens {max_new_tokens} below "
                f"min_out_tokens {self._config.min_out_tokens} (reference "
                "min_tokens semantics)")
        b, t = ids.shape
        total = t + max_new_tokens
        if total > self._config.max_tokens:
            raise RuntimeError(
                f"generate: input+new tokens {total} exceeds max_tokens "
                f"{self._config.max_tokens} (reference max_out_tokens "
                "semantics); raise it in the inference config")
        mcfg = self.module.config
        model_max = getattr(mcfg, "max_seq_len", None)
        if model_max is not None and total > model_max:
            raise RuntimeError(
                f"generate: input+new tokens {total} exceeds the model's "
                f"max_seq_len {model_max} (position table size)")
        vocab = getattr(mcfg, "vocab_size", None)
        if top_k and vocab is not None and top_k > vocab:
            raise ValueError(f"generate: top_k {top_k} > vocab_size {vocab}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"generate: top_p must be in (0, 1], got {top_p}")
        run = self._build_generate(b, t, max_new_tokens, do_sample=do_sample,
                                   top_k=top_k, top_p=float(top_p),
                                   eos_token_id=eos_token_id,
                                   pad_token_id=pad_token_id)
        gen = self._gen_rng if seed is None else torch.Generator(
            device=self.device).manual_seed(seed)
        temp = max(float(temperature), 1e-6)
        new = run(self.params, ids.to(self.device), temp, gen)
        return torch.cat([ids, new.cpu().long()], dim=1)

    def _build_generate(self, b: int, t: int, max_new: int, *,
                        do_sample: bool, top_k: int, top_p: float,
                        eos_token_id: Optional[int], pad_token_id: int):
        """The prefill and the decode loop, composed on the host. The cache
        is padded to a multiple of 128 positions (the reference's allocation,
        which its flash-decode gate needs: ops/attention.decode_route);
        masking by the index keeps the padding inert."""
        prefill, decode = self._generate_programs(b, t, max_new, do_sample,
                                                  top_k, top_p)
        if eos_token_id is None:
            def gen(params, ids, temp, rng):
                tok, cache = prefill(params, ids, temp, rng)
                return decode(params, tok, cache, temp, rng)

            return gen
        pick = self._make_pick(do_sample, top_k, top_p)
        model = self.module

        @torch.no_grad()
        def gen_eos(params, ids, temp, rng):
            tok, cache = prefill(params, ids, temp, rng)
            done = tok == eos_token_id
            buf = torch.full((b, max_new), pad_token_id, dtype=torch.int32,
                             device=tok.device)
            for i in range(max_new):
                buf[:, i] = tok
                # one host read of a device flag per token: the loop ends
                # once every row has emitted EOS (the reference's
                # while_loop condition), and the last token needs no step
                if i + 1 == max_new or bool(done.all()):
                    break
                logits, cache = model.forward_with_cache(
                    params, tok[:, None].long(), cache)
                tok = torch.where(done, torch.full_like(tok, pad_token_id),
                                  pick(logits[:, -1], temp, rng))
                done = done | (tok == eos_token_id)
            return buf

        return gen_eos

    def _generate_programs(self, b: int, t: int, max_new: int,
                           do_sample: bool, top_k: int, top_p: float):
        model, dtype = self.module, self.dtype
        pick = self._make_pick(do_sample, top_k, top_p)
        cache_len = (t + max_new + 127) // 128 * 128

        @torch.no_grad()
        def prefill(params, ids, temp, rng):
            cache = model.init_cache(b, cache_len, dtype=dtype,
                                     device=ids.device)
            logits, cache = model.forward_with_cache(params, ids, cache)
            return pick(logits[:, -1], temp, rng), cache

        @torch.no_grad()
        def decode(params, tok, cache, temp, rng):
            toks = [tok]
            for _ in range(max_new - 1):
                logits, cache = model.forward_with_cache(
                    params, tok[:, None].long(), cache)
                tok = pick(logits[:, -1], temp, rng)
                toks.append(tok)
            return torch.stack(toks, dim=1)

        return prefill, decode

    @staticmethod
    def _make_pick(do_sample: bool, top_k: int = 0, top_p: float = 1.0):
        """Token selection shared by :meth:`generate` and its programs:
        ``pick(logits [B, V], temp, gen) -> int32 [B]``. Greedy is the f32
        argmax (first index on ties); sampling draws from
        ``filter_logits(logits / temp)`` by the Gumbel-max rule with
        uniforms from ``gen`` (the categorical draw of
        ``jax.random.categorical``; torch's bits, so tokens match the
        reference in distribution only)."""

        def pick(logits: torch.Tensor, temp: float, gen: torch.Generator):
            if not do_sample:
                return greedy_pick(logits)
            logits = filter_logits(logits.float() / temp, top_k=top_k,
                                   top_p=top_p)
            u = torch.rand(logits.shape, generator=gen, device=logits.device)
            gumbel = -torch.log(-torch.log(
                u.clamp_min(torch.finfo(torch.float32).tiny)))
            return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)

        return pick

    def programs(self, batch: int, prompt_len: int, max_new: int, *,
                 do_sample: bool = False, top_k: int = 0, top_p: float = 1.0):
        """The ``(prefill, decode)`` closures :meth:`generate` composes for
        this shape without EOS (the reference's ``compiled_programs``), for
        benches that time them apart.

        ``prefill(params, ids [B, T], temp, gen) -> (first_token [B],
        cache)``; ``decode(params, first_token, cache, temp, gen) -> tokens
        [B, max_new]``. decode writes the cache in place: run prefill again
        before each decode call."""
        return self._generate_programs(batch, prompt_len, max_new, do_sample,
                                       top_k, float(top_p))

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

    # ------------------------------------------ block-paged serving programs
    def block_prefill_program(self, bucket_len: int, num_slots: int,
                              max_blocks: int) -> Callable:
        """Suffix prefill against the block pool: run ONE request's
        bucket-padded unmatched suffix through the pool with the slot's
        ``[1, MB]`` table row. The suffix attends over the radix-matched
        prefix already in the pool (``start`` = matched length) and its K/V
        scatter through the table; pad positions land in the slot's private
        blocks or the garbage row, never in a shared block (those lie below
        ``start``). The slot's length becomes ``start + length``.

        Signature: ``(params, k_pool, v_pool, lengths, ids[1, bucket],
        table_row[1, MB], slot, start, length) -> (k_pool, v_pool, lengths,
        first_token[])``; the pools are updated in place."""
        key = ("blk_pf", bucket_len, num_slots, max_blocks)
        if key not in self._programs:
            model = self.module

            @torch.no_grad()
            def prefill(params, k_pool, v_pool, lengths, ids, table_row, slot,
                        start, length):
                idx = torch.full((1,), int(start), dtype=torch.int32,
                                 device=ids.device)
                cache = {"k": k_pool, "v": v_pool, "index": idx,
                         "block_table": table_row}
                logits, cache = model.forward_with_cache(params, ids, cache)
                lengths[int(slot)] = int(start) + int(length)
                last = logits[:, int(length) - 1]                 # [1, V]
                return cache["k"], cache["v"], lengths, greedy_pick(last)[0]

            self._programs[key] = prefill
        return self._programs[key]

    def block_decode_program(self, num_slots: int, max_blocks: int, *,
                             pad_token_id: int = 0) -> Callable:
        """Block-paged decode step: one token for every slot, K/V addressed
        through the full ``[B, MB]`` block table (single-token steps on the
        card run the block decode kernel, ops/decode_step). Inactive slots
        carry sentinel tables: their writes land in the pool's garbage row.

        Signature: ``(params, k_pool, v_pool, lengths[B], tables[B, MB],
        tokens[B], active[B] bool) -> (k_pool, v_pool, lengths,
        next_tokens[B])``."""
        key = ("blk_dec", num_slots, max_blocks, pad_token_id)
        if key not in self._programs:
            model = self.module

            @torch.no_grad()
            def decode(params, k_pool, v_pool, lengths, tables, tokens,
                       active):
                cache = {"k": k_pool, "v": v_pool, "index": lengths,
                         "block_table": tables}
                logits, cache = model.forward_with_cache(
                    params, tokens[:, None].long(), cache)
                pad = torch.full_like(tokens, pad_token_id)
                nxt = torch.where(active, greedy_pick(logits[:, -1]), pad)
                lengths = torch.where(active, lengths + 1, lengths)
                return cache["k"], cache["v"], lengths, nxt

            self._programs[key] = decode
        return self._programs[key]

    @staticmethod
    def block_copy_program() -> Callable:
        """Copy-on-write fork: duplicate pool block ``src`` into ``dst`` in
        both pools across every layer, payload and scales of a quantized
        pool alike, so the fork dequantizes bit-identically to the shared
        original. A plain tensor copy (the reference has no kernel for it).

        Signature: ``(k_pool, v_pool, src, dst) -> (k_pool, v_pool)``."""

        @torch.no_grad()
        def copy(k_pool, v_pool, src, dst):
            for pool in (k_pool, v_pool):
                leaves = pool.values() if isinstance(pool, dict) else (pool,)
                for leaf in leaves:
                    leaf[:, int(dst)].copy_(leaf[:, int(src)])
            return k_pool, v_pool

        return copy
