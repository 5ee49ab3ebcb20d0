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
programs the continuous-batching server drives: the slot-paged prefill,
chunk prefill and decode step, their block-paged analogs (suffix or chunk
prefill, decode through the block table, the copy-on-write block copy),
both stores' preemption swap-out and swap-in, the speculative verify step
over either store and a draft model's drafting program. JAX ``jit``
programs become
closures counted by signature as jit counts its entries
(inference/programs.py), and each decode program (the slot and block
serving steps and verify steps, the drafting program, generate's token
step) is captured once per signature as a CUDA graph on the card and
replayed every token, by the owner of the buffers the graph reads: the
serving engine over its KV store, the drafter over its draft cache, and for
generate one decode state per step shape (its cache; the most recently
used ``MAX_DECODE_STATES`` are kept). The caches are updated in place
instead of being donated. :meth:`InferenceEngine.jit_cache_sizes` reads
the entry counts. The serving programs pick as ``generate`` does: greedily
(argmax, first index on ties) or by sampling from a ``torch.Generator``.
"""

from __future__ import annotations

from collections import Counter, OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.compression.quantize import quantize_int8
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.programs import (GraphPool, GraphProgram,
                                                    Program)
from deepspeed_tpu_torch.ops.attention import (extract_slot_kv,
                                               gather_pool_blocks,
                                               insert_slot_kv,
                                               scatter_pool_blocks,
                                               write_slot_prefix)
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

    # generate's decode states kept at once (each holds a stacked cache and
    # its step's CUDA graph)
    MAX_DECODE_STATES = 2

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
        # the reference's compiled programs, by its keys, counted by
        # signature; a decode program's CUDA graphs belong to the owner of
        # the buffers they read (a ServingEngine, a generate decode state)
        # and share one memory pool
        self._programs: Dict[Tuple, Program] = {}
        self._graph_pool = GraphPool()
        # generate's decode states by step shape, least recently used first
        self._decode_states: "OrderedDict[Tuple, _DecodeState]" = OrderedDict()
        self._evicted_captures: Counter = Counter()
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
        """The prefill and the decode loop, composed on the host (the
        reference's ``gen`` closure). The cache is padded to a multiple of
        128 positions (the reference's allocation, which its flash-decode
        gate needs: ops/attention.decode_route); masking by the index keeps
        the padding inert."""
        prefill, decode = self._generate_programs(
            b, t, max_new, do_sample, top_k, top_p, eos_token_id, pad_token_id)

        def gen(params, ids, temp, rng):
            tok, cache = prefill(params, ids, temp, rng)
            return decode(params, tok, cache, temp, rng)

        return gen

    def _generate_programs(self, b: int, t: int, max_new: int,
                           do_sample: bool, top_k: int, top_p: float,
                           eos_token_id: Optional[int] = None,
                           pad_token_id: int = 0):
        """``(prefill, decode)`` of one generate shape: the reference's
        ``pf`` program and its ``dec`` (or, with ``eos_token_id``,
        ``dec_eos``) program, each counted by signature under the
        reference's key. Prefill writes the cache of the shape's decode
        state (:meth:`_decode_state`) and returns it stamped with the
        state's generation; decode is a host loop over the state's captured
        token step, and raises on a cache that a later prefill overwrote or
        whose state was evicted."""
        total = t + max_new
        cache_len = (total + 127) // 128 * 128
        state_key = (b, cache_len, do_sample, top_k, top_p)
        pf_key = ("pf", b, t, total, do_sample, top_k, top_p)
        if eos_token_id is None:
            dec_key = ("dec", b, total, max_new, do_sample, top_k, top_p)
        else:
            dec_key = ("dec_eos", b, total, max_new, do_sample, top_k, top_p,
                       eos_token_id, pad_token_id)
        if pf_key not in self._programs:
            model = self.module
            pick = self._make_pick(do_sample, top_k, top_p)

            @torch.no_grad()
            def prefill_fn(params, ids, temp, rng, k, v):
                cache = {"k": k, "v": v, "index": 0}
                logits, _ = model.forward_with_cache(params, ids, cache)
                return pick(logits[:, -1], temp, rng)

            self._programs[pf_key] = Program(prefill_fn, "prefill")
        pf = self._programs[pf_key]

        def prefill(params, ids, temp, rng):
            state = self._decode_state(*state_key)
            tok = pf(params, ids, temp, rng, state.k, state.v)
            state.generation += 1
            return tok, {"k": state.k, "v": state.v, "index": t,
                         "generation": state.generation}

        if dec_key not in self._programs:
            if eos_token_id is None:
                loop = self._decode_loop(state_key, max_new)
            else:
                loop = self._decode_loop_eos(state_key, max_new, eos_token_id,
                                             pad_token_id)
            self._programs[dec_key] = Program(loop, "decode")
        return prefill, self._programs[dec_key]

    def _decode_loop(self, state_key: Tuple, max_new: int):
        """The ``dec`` program: ``max_new - 1`` replays of the token step."""
        b = state_key[0]

        @torch.no_grad()
        def decode(params, tok, cache, temp, rng):
            state = self._state_of(state_key, cache, tok, temp)
            out = torch.empty((b, max_new), dtype=torch.int32,
                              device=tok.device)
            out[:, 0] = state.tok
            for i in range(1, max_new):
                state.step(params, state.k, state.v, state.index, state.tok,
                           state.temp, rng)
                out[:, i] = state.tok
            return out

        return decode

    def _decode_loop_eos(self, state_key: Tuple, max_new: int,
                         eos_token_id: int, pad_token_id: int):
        """The ``dec_eos`` program: a row emits ``pad_token_id`` after its
        EOS, and the loop ends once every row has emitted EOS."""
        b = state_key[0]

        @torch.no_grad()
        def decode(params, tok, cache, temp, rng):
            state = self._state_of(state_key, cache, tok, temp)
            tok = state.tok.clone()
            done = tok == eos_token_id
            pad = torch.full_like(tok, pad_token_id)
            buf = torch.full((b, max_new), pad_token_id, dtype=torch.int32,
                             device=tok.device)
            for i in range(max_new):
                buf[:, i] = tok
                # one host read of a device flag per token, after the step:
                # the loop ends once every row has emitted EOS (the
                # reference's while_loop condition), and the last token
                # needs no step
                if i + 1 == max_new or bool(done.all()):
                    break
                state.step(params, state.k, state.v, state.index, state.tok,
                           state.temp, rng)
                tok = torch.where(done, pad, state.tok)
                state.tok.copy_(tok)
                done = done | (tok == eos_token_id)
            return buf

        return decode

    def _state_of(self, state_key: Tuple, cache: dict, tok, temp
                  ) -> "_DecodeState":
        """The decode state that ``cache`` (a prefill's) is the cache of,
        set to start decoding it: the index at the prompt's end, the first
        token and the temperature in the step's buffers. Raises if a later
        prefill overwrote the cache or its state was evicted."""
        state = self._decode_states.get(state_key)
        if state is None or cache["k"] is not state.k:
            raise RuntimeError(
                "generate decode: this cache's decode state was evicted by "
                "other generate shapes; run its prefill again")
        if cache["generation"] != state.generation:
            raise RuntimeError(
                "generate decode: a later prefill of this shape overwrote "
                "the cache; run its prefill again before decoding")
        self._decode_states.move_to_end(state_key)
        state.index.fill_(cache["index"])
        if tok.data_ptr() != state.tok.data_ptr():
            state.tok.copy_(tok)
        state.temp.fill_(temp)
        return state

    def _decode_state(self, b: int, cache_len: int, do_sample: bool,
                      top_k: int, top_p: float) -> "_DecodeState":
        """The decode state of one generate step shape (made on first use,
        the most recently used kept): its stacked cache, token buffer,
        device index and temperature, and its token step, a
        :class:`GraphProgram` over them (one token, in place: write the
        token's K/V at the index, pick the next token into the token
        buffer, advance the index). Every generate shape that pads to the
        same cache, with or without EOS, shares it. At most
        ``MAX_DECODE_STATES`` are kept: making another evicts the least
        recently used, its cache and its graph."""
        key = (b, cache_len, do_sample, top_k, top_p)
        if key in self._decode_states:
            self._decode_states.move_to_end(key)
            return self._decode_states[key]
        while len(self._decode_states) >= self.MAX_DECODE_STATES:
            old_key, old = self._decode_states.popitem(last=False)
            self._evicted_captures[old_key] += old.step.captures
        model = self.module
        pick = self._make_pick(do_sample, top_k, top_p)

        @torch.no_grad()
        def step(params, k, v, index, tok, temp, rng):
            cache = {"k": k, "v": v, "index": index}
            logits, _ = model.forward_with_cache(
                params, tok[:, None].long(), cache)
            tok.copy_(pick(logits[:, -1], temp, rng))
            index.add_(1)

        state = _DecodeState(model, b, cache_len, self.dtype, self.device,
                             GraphProgram(Program(step, f"decode step {key}"),
                                          self._graph_pool))
        self._decode_states[key] = state
        return state

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
        [B, max_new]``. The cache is the shape's decode state's own (its
        step's CUDA graph on the card reads it there, captured at the first
        decode step) and ``cache["index"]`` the prompt length; decode
        starts from that index and writes the cache in place. A later
        prefill of any shape that shares the state overwrites the cache,
        and decoding the older cache then raises, as it does once
        ``MAX_DECODE_STATES`` other shapes evicted its state."""
        return self._generate_programs(batch, prompt_len, max_new, do_sample,
                                       top_k, float(top_p))

    # ----------------------------------------- continuous-batching programs
    # Every serving program picks as generate does (greedy, or sampled with
    # the temperature ``temp`` and the generator ``rng``; greedy takes
    # ``None``), one program per sampling setting (the reference's keys).
    def slot_prefill_program(self, bucket_len: int, num_slots: int,
                             max_len: int, *, do_sample: bool = False,
                             top_k: int = 0, top_p: float = 1.0) -> Callable:
        """Slot-insert prefill for the serving runtime: run ONE request's
        bucket-padded prompt through a fresh bucket-sized cache, copy the
        prefix K/V into slot ``slot`` of the persistent cache, set the slot's
        valid length, and pick the first token from the logits at the TRUE
        last prompt position (the pad tokens behind it are causally
        invisible).

        Signature: ``(params, k_slots, v_slots, lengths, ids[1, bucket],
        slot, length, temp, rng) -> (k_slots, v_slots, lengths,
        first_token[])``; the slot tensors are updated in place."""
        key = ("slot_pf", bucket_len, num_slots, max_len, do_sample, top_k,
               float(top_p))
        if key not in self._programs:
            model, dtype = self.module, self.dtype
            pick = self._make_pick(do_sample, top_k, float(top_p))

            @torch.no_grad()
            def prefill(params, k_slots, v_slots, lengths, ids, slot, length,
                        temp, rng):
                cache = model.init_cache(1, bucket_len, dtype=dtype,
                                         device=k_slots.device)
                logits, cache = model.forward_with_cache(params, ids, cache)
                write_slot_prefix(k_slots, v_slots, cache["k"], cache["v"],
                                  int(slot))
                lengths[int(slot)] = int(length)
                last = logits[:, int(length) - 1]                 # [1, V]
                return k_slots, v_slots, lengths, pick(last, temp, rng)[0]

            self._programs[key] = Program(prefill, f"slot prefill {bucket_len}",
                                          work=("forward", 1, bucket_len))
        return self._programs[key]

    def slot_decode_program(self, num_slots: int, max_len: int, *,
                            do_sample: bool = False, top_k: int = 0,
                            top_p: float = 1.0,
                            pad_token_id: int = 0) -> Callable:
        """Persistent-cache decode step: ONE token for every slot against the
        slot cache with the per-slot length vector (read on the device by the
        fused decode kernel; the host never waits on it). Inactive slots keep
        their length and emit ``pad_token_id``; their masked garbage write
        lands at their stale length (dropped if that is past the cache) and
        is overwritten by the next prefill into the slot. ``lengths``
        advances in place. Its per-step inputs are ``tokens`` and
        ``active``: the serving engine that owns the slot cache captures
        it in its own :class:`GraphProgram` on :meth:`graph_pool` (a
        sampling step's generator registered with the graph).

        Signature: ``(params, k_slots, v_slots, lengths[B], tokens[B],
        active[B] bool, temp, rng) -> (k_slots, v_slots, lengths,
        next_tokens[B])``."""
        key = ("slot_dec", num_slots, max_len, do_sample, top_k, float(top_p),
               pad_token_id)
        if key not in self._programs:
            model = self.module
            pick = self._make_pick(do_sample, top_k, float(top_p))

            @torch.no_grad()
            def decode(params, k_slots, v_slots, lengths, tokens, active,
                       temp, rng):
                cache = {"k": k_slots, "v": v_slots, "index": lengths}
                logits, cache = model.forward_with_cache(
                    params, tokens[:, None].long(), cache)
                pad = torch.full_like(tokens, pad_token_id)
                nxt = torch.where(active, pick(logits[:, -1], temp, rng), pad)
                lengths.add_(active.to(lengths.dtype))
                return cache["k"], cache["v"], lengths, nxt

            self._programs[key] = Program(decode, "slot decode",
                                          inputs=(4, 5),
                                          work=("forward", num_slots, 1))
        return self._programs[key]

    def slot_verify_program(self, num_slots: int, max_len: int, k: int, *,
                            do_sample: bool = False, top_k: int = 0,
                            top_p: float = 1.0,
                            pad_token_id: int = 0) -> Callable:
        """Speculative verify step over the slot cache
        (serving/speculative.py): score ``k`` drafts per slot in one
        forward and emit each slot's accepted prefix plus one token.

        The ``[B, k+1]`` block (the last committed token, then the drafts)
        runs through the decode step's ``forward_with_cache``: per-slot
        positions from the length vector, the block's K/V written at
        ``lengths[b] ..`` (ops/attention.write_kv_cache, B x (k+1) rows),
        the per-slot prefix plus the block's causal part visible
        (ops/attention.decode_attention; the reference runs no Pallas kernel
        here either). Then :func:`~deepspeed_tpu_torch.serving.speculative.
        speculative_acceptance` on the device, and ``lengths`` advances in
        place by ``n_emit`` (0 for an inactive slot, whose writes lie past
        its length). Rejected entries stay behind the length mask and the
        next block overwrites them. One program per k-bucket, per-step
        inputs ``tokens``, ``draft_len`` and ``active`` (the serving engine
        captures it in its own :class:`GraphProgram`).

        Signature: ``(params, k_slots, v_slots, lengths[B], tokens[B, k+1],
        draft_len[B], active[B] bool, temp, rng) -> (k_slots, v_slots,
        lengths, emitted[B, k+2])``: ``emitted`` is serving/speculative.
        pack_emitted's int32 tensor (``out_tokens[B, k+1]``, then
        ``n_emit``), which its ``verify_to_host`` reads in one copy; row b
        emits ``out_tokens[b, :n_emit[b]]``."""
        key = ("slot_ver", num_slots, max_len, k, do_sample, top_k,
               float(top_p), pad_token_id)
        if key not in self._programs:
            model = self.module
            accept = _acceptance(do_sample, top_k, float(top_p), pad_token_id)

            @torch.no_grad()
            def verify(params, k_slots, v_slots, lengths, tokens, draft_len,
                       active, temp, rng):
                cache = {"k": k_slots, "v": v_slots, "index": lengths}
                logits, cache = model.forward_with_cache(
                    params, tokens.long(), cache)
                return (cache["k"], cache["v"]) + accept(
                    logits, tokens, draft_len, active, lengths, temp, rng)

            self._programs[key] = Program(verify, f"slot verify {k}",
                                          inputs=(4, 5, 6),
                                          work=("forward", num_slots, k + 1))
        return self._programs[key]

    def slot_draft_program(self, window_len: int, num_slots: int,
                           k: int) -> Callable:
        """Greedy drafting by a DRAFT model (serving/speculative.
        DraftModelDrafter): prefill each slot's right-padded trailing
        ``window_len`` history tokens into the draft cache from position 0,
        pick the first draft at each row's true last window position, then
        roll ``k - 1`` greedy single-token steps forward at ``wlen + j`` (on
        the card the fused decode kernel, per-slot index). Nothing persists
        between calls: the prefill writes positions below ``window_len``
        and each rollout step writes ``wlen + j`` before the mask exposes
        it, so the cache needs no zeroing. One program per ``(window, k)``;
        its per-step inputs are ``window`` and ``wlen``, and the drafter
        that owns the cache captures it in its own :class:`GraphProgram`.

        Signature: ``(params, k_cache, v_cache, window[B, window_len],
        wlen[B] >= 1) -> drafts[B, k]`` int32, the cache ``[L, B, Hkv, S,
        Dh]`` with ``S >= window_len + k``."""
        key = ("slot_draft", window_len, num_slots, k)
        if key not in self._programs:
            model = self.module

            @torch.no_grad()
            def draft(params, k_cache, v_cache, window, wlen):
                zeros = torch.zeros((num_slots,), dtype=torch.int32,
                                    device=window.device)
                logits, cache = model.forward_with_cache(
                    params, window.long(),
                    {"k": k_cache, "v": v_cache, "index": zeros})
                last = (wlen.long() - 1)[:, None, None]
                tok = greedy_pick(torch.take_along_dim(logits, last,
                                                       dim=1)[:, 0])
                out, idx = [tok], wlen
                for _ in range(k - 1):
                    logits, cache = model.forward_with_cache(
                        params, tok[:, None].long(),
                        {"k": cache["k"], "v": cache["v"], "index": idx})
                    tok = greedy_pick(logits[:, -1])
                    out.append(tok)
                    idx = idx + 1
                return torch.stack(out, dim=1)

            self._programs[key] = Program(draft, f"slot draft {k}",
                                          inputs=(3, 4),
                                          work=("draft", num_slots, window_len,
                                                k))
        return self._programs[key]

    def slot_chunk_prefill_program(self, bucket_len: int, num_slots: int,
                                   max_len: int, *, do_sample: bool = False,
                                   top_k: int = 0,
                                   top_p: float = 1.0) -> Callable:
        """Mid-prompt chunk prefill against the slot cache: ONE request's
        bucket-padded chunk runs over slot ``slot``'s own row (a batch-1
        view, :func:`extract_slot_kv`), so its queries attend over the
        ``start`` tokens already prefilled there plus the chunk's own causal
        block, and its K/V land at ``start ..`` in place (the per-slot write
        path; pad positions past the row are dropped, and those within it
        lie past the slot's length). The pick at the chunk's true last
        position is the first token only for the last chunk (the engine
        reads it then).

        Signature: ``(params, k_slots, v_slots, lengths, ids[1, bucket],
        slot, start, length, temp, rng) -> (k_slots, v_slots, lengths,
        token[])``."""
        key = ("slot_chunk_pf", bucket_len, num_slots, max_len, do_sample,
               top_k, float(top_p))
        if key not in self._programs:
            model = self.module
            pick = self._make_pick(do_sample, top_k, float(top_p))

            @torch.no_grad()
            def chunk(params, k_slots, v_slots, lengths, ids, slot, start,
                      length, temp, rng):
                k_row, v_row = extract_slot_kv(k_slots, v_slots, int(slot))
                idx = torch.full((1,), int(start), dtype=torch.int32,
                                 device=ids.device)
                logits, _ = model.forward_with_cache(
                    params, ids, {"k": k_row, "v": v_row, "index": idx})
                lengths[int(slot)] = int(start) + int(length)
                last = logits[:, int(length) - 1]                 # [1, V]
                return k_slots, v_slots, lengths, pick(last, temp, rng)[0]

            self._programs[key] = Program(chunk,
                                          f"slot chunk prefill {bucket_len}",
                                          work=("forward", 1, bucket_len))
        return self._programs[key]

    def slot_swap_out_program(self, num_slots: int, max_len: int) -> Callable:
        """Preemption swap-out for the slot cache: slot ``slot``'s row pair
        (views; the engine copies them to the host). Reads only.

        Signature: ``(k_slots, v_slots, slot) -> (k_row, v_row)``, rows
        ``[L, 1, Hkv, S, Dh]``."""
        key = ("slot_swap_out", num_slots, max_len)
        if key not in self._programs:
            self._programs[key] = Program(
                lambda k, v, slot: extract_slot_kv(k, v, int(slot)),
                "slot swap out", work=("kv", max_len, 1))
        return self._programs[key]

    def slot_swap_in_program(self, num_slots: int, max_len: int) -> Callable:
        """Preemption swap-in for the slot cache: write a parked row pair
        (host tensors, pinned on the card) back into slot ``slot`` and
        restore its length, in place.

        Signature: ``(k_slots, v_slots, k_row, v_row, lengths, slot,
        length) -> (k_slots, v_slots, lengths)``."""
        key = ("slot_swap_in", num_slots, max_len)
        if key not in self._programs:

            @torch.no_grad()
            def swap_in(k_slots, v_slots, k_row, v_row, lengths, slot, length):
                insert_slot_kv(k_slots, v_slots, k_row, v_row, int(slot))
                lengths[int(slot)] = int(length)
                return k_slots, v_slots, lengths

            self._programs[key] = Program(swap_in, "slot swap in",
                                          work=("kv", max_len, 1))
        return self._programs[key]

    # ------------------------------------------ block-paged serving programs
    def block_prefill_program(self, bucket_len: int, num_slots: int,
                              max_blocks: int, *, do_sample: bool = False,
                              top_k: int = 0, top_p: float = 1.0,
                              kv_dtype: Optional[str] = None) -> Callable:
        """Suffix prefill against the block pool: run ONE request's
        bucket-padded unmatched suffix (or a chunk of it: ``start`` is then
        the chunk's offset) through the pool with the slot's ``[1, MB]``
        table row. The suffix attends over the prefix already in the pool
        (``start`` tokens) and its K/V scatter through the table; pad
        positions land in the slot's private blocks or the garbage row,
        never in a shared block (those lie below ``start``). The slot's
        length becomes ``start + length``.

        Signature: ``(params, k_pool, v_pool, lengths, ids[1, bucket],
        table_row[1, MB], slot, start, length, temp, rng) -> (k_pool,
        v_pool, lengths, first_token[])``; the pools are updated in place.
        One program per pool type ``kv_dtype`` (None: the compute dtype)."""
        key = ("blk_pf", bucket_len, num_slots, max_blocks, do_sample, top_k,
               float(top_p), kv_dtype)
        if key not in self._programs:
            model = self.module
            pick = self._make_pick(do_sample, top_k, float(top_p))

            @torch.no_grad()
            def prefill(params, k_pool, v_pool, lengths, ids, table_row, slot,
                        start, length, temp, rng):
                idx = torch.full((1,), int(start), dtype=torch.int32,
                                 device=ids.device)
                cache = {"k": k_pool, "v": v_pool, "index": idx,
                         "block_table": table_row}
                logits, cache = model.forward_with_cache(params, ids, cache)
                lengths[int(slot)] = int(start) + int(length)
                last = logits[:, int(length) - 1]                 # [1, V]
                return (cache["k"], cache["v"], lengths,
                        pick(last, temp, rng)[0])

            self._programs[key] = Program(prefill, f"block prefill {bucket_len}",
                                          work=("forward", 1, bucket_len))
        return self._programs[key]

    def block_decode_program(self, num_slots: int, max_blocks: int, *,
                             do_sample: bool = False, top_k: int = 0,
                             top_p: float = 1.0, pad_token_id: int = 0,
                             kv_dtype: Optional[str] = None) -> Callable:
        """Block-paged decode step: one token for every slot, K/V addressed
        through the full ``[B, MB]`` block table (single-token steps on the
        card run the block decode kernel, ops/decode_step). Inactive slots
        carry sentinel tables: their writes land in the pool's garbage row.
        ``lengths`` advances in place; the table is a persistent operand.
        One program per pool type ``kv_dtype`` (None: the compute dtype),
        whose per-step inputs are ``tokens`` and ``active``: the serving
        engine that owns the pool captures it in its own
        :class:`GraphProgram` on :meth:`graph_pool`.

        Signature: ``(params, k_pool, v_pool, lengths[B], tables[B, MB],
        tokens[B], active[B] bool, temp, rng) -> (k_pool, v_pool, lengths,
        next_tokens[B])``."""
        key = ("blk_dec", num_slots, max_blocks, do_sample, top_k,
               float(top_p), pad_token_id, kv_dtype)
        if key not in self._programs:
            model = self.module
            pick = self._make_pick(do_sample, top_k, float(top_p))

            @torch.no_grad()
            def decode(params, k_pool, v_pool, lengths, tables, tokens,
                       active, temp, rng):
                cache = {"k": k_pool, "v": v_pool, "index": lengths,
                         "block_table": tables}
                logits, cache = model.forward_with_cache(
                    params, tokens[:, None].long(), cache)
                pad = torch.full_like(tokens, pad_token_id)
                nxt = torch.where(active, pick(logits[:, -1], temp, rng), pad)
                lengths.add_(active.to(lengths.dtype))
                return cache["k"], cache["v"], lengths, nxt

            self._programs[key] = Program(decode, "block decode",
                                          inputs=(5, 6),
                                          work=("forward", num_slots, 1))
        return self._programs[key]

    def block_verify_program(self, num_slots: int, max_blocks: int, k: int,
                             *, do_sample: bool = False, top_k: int = 0,
                             top_p: float = 1.0, pad_token_id: int = 0,
                             kv_dtype: Optional[str] = None) -> Callable:
        """Speculative verify step over the block pool, the block-table
        analog of :meth:`slot_verify_program`: the block's K/V scatter
        through the table (ops/attention.write_kv_blocks, quantized on
        store in an int8 or fp8 pool; a position past the table goes to the
        garbage row), then the gather and the einsum attention. Rejected
        entries stay behind the length in the slot's private blocks (a
        shared prefix block lies below every length), and the next block
        overwrites them through the same table. One program per k-bucket
        and pool type ``kv_dtype``; the table is a persistent operand.

        Signature: ``(params, k_pool, v_pool, lengths[B], tables[B, MB],
        tokens[B, k+1], draft_len[B], active[B] bool, temp, rng) ->
        (k_pool, v_pool, lengths, emitted[B, k+2])``, ``emitted`` as
        :meth:`slot_verify_program`'s."""
        key = ("blk_ver", num_slots, max_blocks, k, do_sample, top_k,
               float(top_p), pad_token_id, kv_dtype)
        if key not in self._programs:
            model = self.module
            accept = _acceptance(do_sample, top_k, float(top_p), pad_token_id)

            @torch.no_grad()
            def verify(params, k_pool, v_pool, lengths, tables, tokens,
                       draft_len, active, temp, rng):
                cache = {"k": k_pool, "v": v_pool, "index": lengths,
                         "block_table": tables}
                logits, cache = model.forward_with_cache(
                    params, tokens.long(), cache)
                return (cache["k"], cache["v"]) + accept(
                    logits, tokens, draft_len, active, lengths, temp, rng)

            self._programs[key] = Program(verify, f"block verify {k}",
                                          inputs=(5, 6, 7),
                                          work=("forward", num_slots, k + 1))
        return self._programs[key]

    def block_copy_program(self, num_blocks: int, block_size: int, *,
                           kv_dtype: str = "compute") -> Callable:
        """Copy-on-write fork: duplicate pool block ``src`` into ``dst`` in
        both pools across every layer, payload and scales of a quantized
        pool alike, so the fork dequantizes bit-identically to the shared
        original. A plain tensor copy (the reference has no kernel for it).

        Signature: ``(k_pool, v_pool, src, dst) -> (k_pool, v_pool)``; one
        program per pool (the reference's key)."""
        key = ("blk_copy", num_blocks, block_size, kv_dtype)
        if key not in self._programs:

            @torch.no_grad()
            def copy(k_pool, v_pool, src, dst):
                for pool in (k_pool, v_pool):
                    leaves = pool.values() if isinstance(pool, dict) else (pool,)
                    for leaf in leaves:
                        leaf[:, int(dst)].copy_(leaf[:, int(src)])
                return k_pool, v_pool

            self._programs[key] = Program(copy, "block copy",
                                          work=("kv", block_size, 2))
        return self._programs[key]

    def block_swap_out_program(self, num_blocks: int, max_blocks: int, *,
                               kv_dtype: str = "compute") -> Callable:
        """Preemption swap-out for the block pool: the contents of the
        blocks one slot's table row ``[MB]`` names, ``[L, MB, ...]`` per
        pool leaf (sentinel entries gather the garbage row; the engine
        parks only the blocks the request used). Reads only.

        Signature: ``(k_pool, v_pool, table[MB]) -> (k_blocks,
        v_blocks)``."""
        key = ("blk_swap_out", num_blocks, max_blocks, kv_dtype)
        if key not in self._programs:
            self._programs[key] = Program(
                torch.no_grad()(gather_pool_blocks), "block swap out",
                work=("kv", 0, 1))
        return self._programs[key]

    def block_swap_in_program(self, num_blocks: int, max_blocks: int, *,
                              kv_dtype: str = "compute") -> Callable:
        """Preemption swap-in for the block pool: scatter uploaded block
        contents into the pool rows ``dst`` ``[MB]`` names (the entries the
        restore skips, re-matched shared blocks and unwritten tails, name
        the garbage row) and restore the slot's length, in place.

        Signature: ``(k_pool, v_pool, k_blocks, v_blocks, dst[MB],
        lengths, slot, length) -> (k_pool, v_pool, lengths)``."""
        key = ("blk_swap_in", num_blocks, max_blocks, kv_dtype)
        if key not in self._programs:

            @torch.no_grad()
            def swap_in(k_pool, v_pool, k_blocks, v_blocks, dst, lengths,
                        slot, length):
                scatter_pool_blocks(k_pool, v_pool, k_blocks, v_blocks, dst)
                lengths[int(slot)] = int(length)
                return k_pool, v_pool, lengths

            self._programs[key] = Program(swap_in, "block swap in",
                                          work=("kv", 0, 1))
        return self._programs[key]

    # ------------------------------------------------------------ contract
    @property
    def graph_pool(self) -> GraphPool:
        """The CUDA graph memory pool every decode graph over this engine
        shares (they never run at once)."""
        return self._graph_pool

    def decode_captures(self) -> Dict[str, int]:
        """CUDA graphs captured per generate step shape ``(batch, cache
        length, do_sample, top_k, top_p)``, those of evicted states
        included: above 1, a shape was captured again after its state was
        evicted (or its operands' signature varied). Nothing is captured on
        the CPU."""
        out = Counter(self._evicted_captures)
        for key, state in self._decode_states.items():
            out[key] += state.step.captures
        return {str(key): n for key, n in out.items()}

    def jit_cache_sizes(self) -> Dict[str, int]:
        """Entry count per program this engine has built, by the
        reference's keys (``str(key)``): recompile accounting for telemetry
        (a program whose count keeps growing is recompiling; on the card
        each entry of a decode program is one captured CUDA graph)."""
        return {str(key): prog._cache_size()
                for key, prog in self._programs.items()}


def _acceptance(do_sample: bool, top_k: int, top_p: float,
                pad_token_id: int):
    """The verify programs' tail: ``accept(logits, tokens, draft_len,
    active, lengths, temp, rng) -> (lengths, emitted)``, the acceptance
    rule with inactive rows emitting nothing (pad tokens, n_emit 0),
    ``lengths`` advanced in place, the tokens and counts packed by
    serving/speculative.pack_emitted."""
    from deepspeed_tpu_torch.serving.speculative import (
        pack_emitted, speculative_acceptance)

    def accept(logits, tokens, draft_len, active, lengths, temp, rng):
        out, n_emit = speculative_acceptance(
            logits, tokens, draft_len, temp, rng, do_sample=do_sample,
            top_k=top_k, top_p=top_p, pad_token_id=pad_token_id)
        n_emit = torch.where(active, n_emit, torch.zeros_like(n_emit))
        out = torch.where(active[:, None], out,
                          torch.full_like(out, pad_token_id))
        lengths.add_(n_emit.to(lengths.dtype))
        return lengths, pack_emitted(out, n_emit)

    return accept


class _DecodeState:
    """What one generate step shape owns: the stacked cache ``[L, B, Hkv,
    S, Dh]`` that its prefills write, the token buffer ``[B]``, the 0-dim
    int32 index on the device, the 0-dim temperature, and ``step``, the
    token step whose CUDA graph reads and writes these addresses.
    ``generation`` counts the prefills written into the cache."""

    def __init__(self, model, b: int, cache_len: int, dtype, device,
                 step: GraphProgram):
        cache = model.init_cache(b, cache_len, dtype=dtype, device=device)
        self.k, self.v = cache["k"], cache["v"]
        self.index = torch.zeros((), dtype=torch.int32, device=device)
        self.tok = torch.zeros((b,), dtype=torch.int32, device=device)
        self.temp = torch.ones((), dtype=torch.float32, device=device)
        self.generation = 0
        self.step = step
