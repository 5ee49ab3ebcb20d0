"""GPT-2 model family (port of deepspeed_tpu/models/gpt2.py: the training
path and the cached inference path).

Parameters are an explicit dict in the JAX package's layout — stacked
``blocks/* [L, in, out]``, ``wte [V, D]``, ``wpe [S, D]`` — so a JAX
parameter tree carries over by a copy (inference/weights.py). Activations
and matmuls run in ``compute_dtype`` (bf16 by default, whatever the
engine's precision: the reference's default too), layer-norm statistics,
softmax and the loss in f32. Attention is the dense op
(ops/attention.multihead_attention, with attention dropout when training)
or, with ``attn_impl="flash"``, the flash attention kernels.
``forward_with_cache`` runs prefill and decode against a stacked KV cache
``[L, B, H, S, Dh]`` (or a block pool) through ops/attention.cached_attention,
in the logical unpacked layout: the reference's token-pair packing for Dh <
128 is a TPU tiling device with no counterpart here.

``remat=True`` runs each block under an activation checkpointing policy
(runtime/activation_checkpointing.py, ``remat_policy``) and
``GPT2Config(loss_chunk>0)`` takes the LM loss in sequence chunks without
``[B, T, V]`` logits (runtime/zero/tiling.py), as the reference. When
training, ``pld_theta`` gates each block by progressive layer drop and
``ltd_keep`` runs the middle layers on a random subset of the tokens
(random-LTD), as the reference's two branches. Not ported yet, and
refused rather than ignored: the sequence-parallel attention forms.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.compression.quantize import quantize_int8
from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.models.base import (ATTN_IMPLS, SEQUENCE_PARALLEL_IMPLS,
                                             cache_positions,
                                             cross_entropy_loss, embed_tokens,
                                             gelu, layer_norm, layer_view,
                                             qdot, sp_attention, tied_logits,
                                             unbind_layers)
from deepspeed_tpu_torch.ops.attention import (alloc_kv_cache,
                                               cached_attention,
                                               multihead_attention)


def _pld_keep(p_keep: float, generator, device) -> torch.Tensor:
    """One Bernoulli(p_keep) draw, a 0-dim bool tensor on ``device``."""
    return torch.rand((), generator=generator, device=device) < p_keep


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    hidden_size: int = 768
    num_heads: int = 12
    mlp_ratio: int = 4
    dropout: float = 0.0
    tie_embeddings: bool = True
    eps: float = 1e-5
    # >0: the LM loss in sequence chunks without [B, T, V] logits
    # (runtime/zero/tiling.py)
    loss_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return self.hidden_size * self.mlp_ratio

    @classmethod
    def gpt2_125m(cls, **kw):
        return cls(num_layers=12, hidden_size=768, num_heads=12, **kw)

    @classmethod
    def gpt2_350m(cls, **kw):
        return cls(num_layers=24, hidden_size=1024, num_heads=16, **kw)

    @classmethod
    def gpt2_774m(cls, **kw):
        return cls(num_layers=36, hidden_size=1280, num_heads=20, **kw)

    @classmethod
    def gpt2_1b3(cls, **kw):
        return cls(num_layers=24, hidden_size=2048, num_heads=16, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        return cls(num_layers=2, hidden_size=64, num_heads=4, **kw)


class GPT2Model:
    """Causal-LM model spec. batch = {"input_ids": [B, T] int, "labels": [B, T]}."""

    supports_weight_quant = True     # block matmuls go through base.qdot
    # the tied table goes through base.embed_tokens / base.tied_logits, so
    # it may be int8 with per-vocab-row scales (quant.quantize_embedding)
    supports_embedding_quant = True

    def __init__(self, config: GPT2Config, compute_dtype=torch.bfloat16,
                 remat: bool = False, remat_policy: Optional[str] = None,
                 attn_impl: str = "dense"):
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; one of {ATTN_IMPLS}")
        if attn_impl in SEQUENCE_PARALLEL_IMPLS:
            raise NotPortedError(f"attn_impl={attn_impl!r} is not ported yet")
        if attn_impl != "dense" and config.dropout > 0.0:
            raise ValueError(
                f"attn_impl={attn_impl!r} does not implement attention dropout; "
                f"set dropout=0.0 or use attn_impl='dense'")
        if config.loss_chunk and not config.tie_embeddings:
            raise ValueError("loss_chunk requires tie_embeddings (the "
                             "chunked LM loss projects through wte)")
        self.config = config
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.remat_policy = remat_policy
        self.attn_impl = attn_impl

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, *, device=None,
             dtype=torch.float32,
             quantize: Optional[Callable[[tuple], bool]] = None):
        """Random parameters from ``generator``: normal(0.02) weights, the
        two residual-output projections scaled by 1 / sqrt(2L), zero biases,
        unit layer-norm scales (the reference's distributions; torch's
        random numbers, not JAX's). A stacked block weight for which
        ``quantize(shape)`` is true becomes an int8 dict with per-layer,
        per-output-column scales (the inference engine's weight-only int8)."""
        c = self.config
        d, l, m, v = c.hidden_size, c.num_layers, c.mlp_dim, c.vocab_size
        device = generator.device if device is None else device

        def normal(shape, scale=1.0):
            w = torch.empty(shape, dtype=torch.float32, device=device)
            w.normal_(0.0, 0.02, generator=generator)
            return (w * scale if scale != 1.0 else w).to(dtype)

        def const(shape, value):
            return torch.full(shape, value, dtype=dtype, device=device)

        out_scale = 1.0 / math.sqrt(2 * l)
        params = {
            "wte": normal((v, d)),
            "wpe": normal((c.max_seq_len, d)),
            "blocks": {
                "ln1_scale": const((l, d), 1.0), "ln1_bias": const((l, d), 0.0),
                "qkv_w": normal((l, d, 3 * d)),
                "qkv_b": const((l, 3 * d), 0.0),
                "attn_out_w": normal((l, d, d), out_scale),
                "attn_out_b": const((l, d), 0.0),
                "ln2_scale": const((l, d), 1.0), "ln2_bias": const((l, d), 0.0),
                "mlp_fc_w": normal((l, d, m)),
                "mlp_fc_b": const((l, m), 0.0),
                "mlp_out_w": normal((l, m, d), out_scale),
                "mlp_out_b": const((l, d), 0.0),
            },
            "ln_f_scale": const((d,), 1.0), "ln_f_bias": const((d,), 0.0),
        }
        if not c.tie_embeddings:
            params["lm_head"] = normal((d, v))
        if quantize is not None:
            blocks = params["blocks"]
            for name, w in list(blocks.items()):
                if quantize(tuple(w.shape)):
                    q, s = quantize_int8(w, reduce_dims=(1,))
                    blocks[name] = {"__q__": q, "__scale__": s}
        return params

    # ---------------------------------------------------------------- layers
    def _qkv(self, x, blk):
        """Attention's operands, each ``[B, T, H, Dh]``."""
        c = self.config
        b, t, d = x.shape
        y = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], c.eps)
        qkv = qdot("btd,de->bte", y, blk["qkv_w"]) + blk["qkv_b"].to(y.dtype)
        return tuple(z.reshape(b, t, c.num_heads, c.head_dim)
                     for z in torch.split(qkv, d, dim=-1))

    def _attend(self, q, k, v, blk, dropout_rng, train: bool):
        """Causal self-attention over the whole sequence (dropout on the
        dense path when training)."""
        if self.attn_impl != "dense":
            return sp_attention(self.attn_impl, q, k, v)
        rate = self.config.dropout if train else 0.0
        return multihead_attention(q, k, v, causal=True, dropout_rate=rate,
                                   dropout_rng=dropout_rng)

    def _out_mlp(self, x, attn, blk, *_):
        """The block's output from attention's: the output projection and
        the MLP, each a residual."""
        c = self.config
        attn = attn.reshape(x.shape)
        x = x + qdot("btd,de->bte", attn, blk["attn_out_w"]) + \
            blk["attn_out_b"].to(x.dtype)
        y = layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], c.eps)
        hmid = gelu(qdot("btd,dm->btm", y, blk["mlp_fc_w"]) +
                    blk["mlp_fc_b"].to(y.dtype))
        return x + qdot("btm,md->btd", hmid, blk["mlp_out_w"]) + \
            blk["mlp_out_b"].to(x.dtype)

    def _block_impl(self, x, blk, dropout_rng, train: bool, cache):
        """One block; with ``cache=(k_full, v_full, layer, idx,
        block_table)`` attention runs against the stacked KV cache (or the
        block pool), written in place. Returns ``(x, k_full, v_full)``."""
        q, k, v = self._qkv(x, blk)
        kc = vc = None
        if cache is not None:
            kc, vc, layer, idx, bt = cache
            # the decode kernels take contiguous rows, not views of qkv
            attn, kc, vc = cached_attention(q.contiguous(), kc, vc,
                                            k.contiguous(), v.contiguous(),
                                            layer, idx, block_table=bt)
        else:
            attn = self._attend(q, k, v, blk, dropout_rng, train)
        return self._out_mlp(x, attn, blk), kc, vc

    def _block(self, x, blk, dropout_rng, train: bool):
        return self._block_impl(x, blk, dropout_rng, train, None)[0]

    def forward_hidden(self, params, input_ids, *, rngs=None,
                       train: bool = False, pld_theta=None, ltd_keep=None):
        """Final-layer-normed hidden states ``[B, T, D]``. ``rngs`` is a
        ``torch.Generator`` (or ``{"dropout": generator}``) for attention
        dropout on the dense path when training, and for the draws of the
        two branches the reference takes when training:

        * random-LTD (``ltd_keep < T`` and 3 or more layers): layers 0 and
          L - 1 run on every token; each middle layer on its own sorted
          random draw of ``ltd_keep`` positions (gather, block, scatter),
          the other tokens passing through unchanged;
        * progressive layer drop (``pld_theta``): block l is kept with
          probability ``p_l = 1 - l / (L - 1) * (1 - theta)`` and gated as
          ``x + keep / p_l * (block(x) - x)``; every block is computed.

        The two are exclusive, as in the reference."""
        c = self.config
        b, t = input_ids.shape
        gen = rngs.get("dropout") if isinstance(rngs, dict) else rngs
        x = embed_tokens(params["wte"], input_ids, self.compute_dtype)
        x = x + params["wpe"][:t].to(self.compute_dtype)[None]
        blocks = params["blocks"]
        if any(isinstance(w, dict) for w in blocks.values()):
            # int8 weights (inference): per-layer views keep them whole
            layers = [layer_view(blocks, i) for i in range(c.num_layers)]
        else:
            layers = unbind_layers(blocks)
        if self.remat:
            from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpoint_block

            block_fn = checkpoint_block(
                lambda x, blk, g: self._qkv(x, blk),
                lambda q, k, v, blk, g: self._attend(q, k, v, blk, g, train),
                self._out_mlp, policy=self.remat_policy)
        else:
            block_fn = lambda x, blk, g: self._block(x, blk, g, train)  # noqa: E731
        if (ltd_keep is not None and train and ltd_keep < t
                and c.num_layers >= 3):
            assert gen is not None, "random-LTD needs a dropout generator"
            assert pld_theta is None, \
                "random-LTD and progressive_layer_drop are exclusive"
            from deepspeed_tpu_torch.runtime.data_pipeline.random_ltd import (
                gather_tokens, sample_token_indices, scatter_tokens)

            x = block_fn(x, layers[0], gen)
            for blk in layers[1:-1]:
                idx = sample_token_indices(gen, b, t, ltd_keep, device=x.device)
                kept = block_fn(gather_tokens(x, idx), blk, gen)
                x = scatter_tokens(x, kept, idx)
            x = block_fn(x, layers[-1], gen)
            return layer_norm(x, params["ln_f_scale"], params["ln_f_bias"],
                              c.eps)

        use_pld = pld_theta is not None and train
        if use_pld:
            assert gen is not None, "pld needs a dropout generator"
        for i, blk in enumerate(layers):
            x_new = block_fn(x, blk, gen)
            if use_pld:
                x = x + self._pld_gate(i, pld_theta, gen, x) * (x_new - x)
            else:
                x = x_new
        return layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], c.eps)

    def _pld_gate(self, i: int, theta: float, gen, x):
        """Layer ``i``'s progressive-layer-drop gate, a 0-dim tensor in x's
        dtype: ``1 / p_keep`` with probability ``p_keep`` (drawn on the
        device: no host read), else 0; ``p_keep`` in f32 as the
        reference's."""
        f32 = np.float32
        frac = f32(i) / f32(max(self.config.num_layers - 1, 1))
        p_keep = f32(1.0) - frac * (f32(1.0) - f32(theta))
        keep = _pld_keep(float(p_keep), gen, x.device)
        with np.errstate(divide="ignore"):
            inv = float(f32(1.0) / p_keep)       # inf at p_keep 0: never kept
        return torch.where(keep, inv, 0.0).to(x.dtype)

    def logits(self, params, hidden):
        if self.config.tie_embeddings:
            return tied_logits(hidden, params["wte"])
        return torch.einsum("btd,dv->btv", hidden,
                            params["lm_head"].to(hidden.dtype))

    def apply(self, params, batch, *, rngs=None, train: bool = False,
              pld_theta=None, ltd_keep=None):
        hidden = self.forward_hidden(params, batch["input_ids"], rngs=rngs,
                                     train=train, pld_theta=pld_theta,
                                     ltd_keep=ltd_keep)
        if self.config.loss_chunk:
            from deepspeed_tpu_torch.runtime.zero.tiling import chunked_cross_entropy

            loss, n = chunked_cross_entropy(hidden, params["wte"],
                                            batch["labels"],
                                            chunk=self.config.loss_chunk)
        else:
            loss, n = cross_entropy_loss(self.logits(params, hidden),
                                         batch["labels"])
        return loss, {"loss": loss, "ntokens": n}

    # ------------------------------------------------------ inference path
    def init_cache(self, batch_size: int, max_len: int, dtype=None,
                   device=None):
        """Stacked KV cache ``[L, B, H, S, Dh]`` (K and V) plus the scalar
        index 0."""
        c = self.config
        dtype = dtype or self.compute_dtype
        shape = (c.num_layers, batch_size, c.num_heads, max_len, c.head_dim)
        return {"k": alloc_kv_cache(*shape, dtype, device),
                "v": alloc_kv_cache(*shape, dtype, device),
                "index": 0}

    def forward_with_cache(self, params, input_ids, cache):
        """Prefill (T > 1) or decode (T == 1) against the KV cache, written in
        place. ``cache["index"]`` is a python int or a per-slot ``[B]`` int32
        tensor (models/base.cache_positions: each row then takes its own
        position embedding and attends over its own prefix); with
        ``cache["block_table"]`` the caches are block pools. Returns
        ``(logits [B, T, V], cache)``; positions past the table read its
        last row, as the reference's clamping gather."""
        c = self.config
        t = input_ids.shape[1]
        idx = cache["index"]
        bt = cache.get("block_table")
        x = embed_tokens(params["wte"], input_ids, self.compute_dtype)
        pos = cache_positions(idx, t, device=x.device).clamp(0, c.max_seq_len - 1)
        pe = params["wpe"][pos].to(self.compute_dtype)
        x = x + (pe if pos.ndim == 2 else pe[None])
        kc, vc = cache["k"], cache["v"]
        for layer in range(c.num_layers):
            x, kc, vc = self._block_impl(
                x, layer_view(params["blocks"], layer), None, False,
                (kc, vc, layer, idx, bt))
        hidden = layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], c.eps)
        out = {"k": kc, "v": vc, "index": idx + t}
        if bt is not None:
            out["block_table"] = bt
        return self.logits(params, hidden), out

    # ------------------------------------------------------------------ cost
    def flops_per_token(self, seq_len: Optional[int] = None,
                        ltd_keep: Optional[int] = None) -> float:
        """6*N approximation + attention quadratic term (training fwd+bwd)
        at ``seq_len`` tokens per sequence (default ``max_seq_len``). With
        ``ltd_keep`` (random-LTD's kept tokens, below ``seq_len``, 3 or more
        layers) the middle layers count ``ltd_keep`` of every ``seq_len``
        tokens at sequence length ``ltd_keep``; the first and last layers,
        the embeddings and the logits every token."""
        c = self.config
        t = c.max_seq_len if seq_len is None else seq_len
        h = c.hidden_size
        embed = c.vocab_size * h + c.max_seq_len * h

        def layer(seq):
            return 6.0 * (4 * h ** 2 + 2 * h * c.mlp_dim) + 12 * h * seq

        if ltd_keep is not None and ltd_keep < t and c.num_layers >= 3:
            return (6.0 * embed + 2 * layer(t)
                    + (c.num_layers - 2) * layer(ltd_keep) * ltd_keep / t)
        n_params = embed + c.num_layers * (4 * h ** 2 + 2 * h * c.mlp_dim)
        attn = 12 * c.num_layers * h * t
        return 6.0 * n_params + attn
