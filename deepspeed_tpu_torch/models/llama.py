"""LLaMA model family for the PyTorch port (port of
deepspeed_tpu/models/llama.py): RMSNorm, RoPE, SwiGLU, grouped-query
attention over layer-stacked weights.

The parameter dict keeps the JAX layout and orientation — ``embed [V, D]``,
stacked ``blocks/* [L, in, out]``, ``final_norm [D]``, ``lm_head [D, V]`` —
so the weight bridge (inference/weights.py) is a copy. The JAX layer scan
becomes a Python loop over :func:`layer_view` dicts; the stacked KV cache
is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.compression.quantize import quantize_int8
from deepspeed_tpu_torch.models.base import layer_view, qdot, rms_norm
from deepspeed_tpu_torch.ops.attention import (alloc_kv_cache,
                                               cached_attention,
                                               multihead_attention)
from deepspeed_tpu_torch.ops.rotary import apply_rotary_pos_emb, rope_frequencies


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    num_layers: int = 32
    hidden_size: int = 4096
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # GQA; None => MHA
    intermediate_size: Optional[int] = None
    rope_theta: float = 10000.0
    eps: float = 1e-5

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size is None:
            # LLaMA: 2/3 * 4h rounded to a multiple of 256
            inter = int(2 * (4 * self.hidden_size) / 3)
            self.intermediate_size = 256 * ((inter + 255) // 256)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def llama_7b(cls, **kw):
        return cls(num_layers=32, hidden_size=4096, num_heads=32, **kw)

    @classmethod
    def llama_13b(cls, **kw):
        return cls(num_layers=40, hidden_size=5120, num_heads=40, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("num_kv_heads", 2)
        return cls(num_layers=2, hidden_size=64, num_heads=4,
                   intermediate_size=128, **kw)


# stacked block matmul weights: (name, in-dim, out-dim, init scale factor)
def _block_matmuls(c: LlamaConfig):
    d, m = c.hidden_size, c.intermediate_size
    hq, hkv, dh = c.num_heads, c.num_kv_heads, c.head_dim
    out_scale = (2 * c.num_layers) ** -0.5
    return [("wq", d, hq * dh, 1.0), ("wk", d, hkv * dh, 1.0),
            ("wv", d, hkv * dh, 1.0), ("wo", hq * dh, d, out_scale),
            ("w_gate", d, m, 1.0), ("w_up", d, m, 1.0),
            ("w_down", m, d, out_scale)]


class LlamaModel:
    """Causal LM over an explicit parameter dict (the JAX ModelSpec shape)."""

    supports_weight_quant = True   # block matmuls go through base.qdot

    def __init__(self, config: LlamaConfig, compute_dtype=torch.bfloat16):
        self.config = config
        self.compute_dtype = compute_dtype
        self._rope: Dict[torch.device, tuple] = {}

    # ------------------------------------------------------------ params
    def init(self, generator: torch.Generator, *, device, dtype,
             quantize: Optional[Callable[[tuple], bool]] = None):
        """Random parameters on ``device`` in ``dtype``: normal(0.02) with the
        JAX package's (2L)^-0.5 scale on ``wo``/``w_down``, ones for the
        norms. Stacked weights are drawn one layer at a time in f32 and cast
        into place, so no full-f32 copy ever exists; a block weight for
        which ``quantize(shape)`` is true becomes an int8 dict with
        per-layer, per-output-column scales, again one layer at a time."""
        c = self.config
        d, l, v = c.hidden_size, c.num_layers, c.vocab_size

        def normal(shape, scale=1.0):
            w = torch.empty(shape, dtype=torch.float32, device=device)
            w.normal_(0.0, 0.02, generator=generator)
            return (w * scale if scale != 1.0 else w).to(dtype)

        params = {"embed": normal((v, d)), "blocks": {}}
        blocks = params["blocks"]
        blocks["attn_norm"] = torch.ones((l, d), dtype=dtype, device=device)
        blocks["mlp_norm"] = torch.ones((l, d), dtype=dtype, device=device)
        for name, din, dout, scale in _block_matmuls(c):
            shape = (l, din, dout)
            if quantize is not None and quantize(shape):
                q = torch.empty(shape, dtype=torch.int8, device=device)
                s = torch.empty((l, 1, dout), dtype=torch.float32, device=device)
                for i in range(l):
                    q[i], s[i] = quantize_int8(normal((din, dout), scale),
                                               per_channel_axis=1)
                blocks[name] = {"__q__": q, "__scale__": s}
            else:
                w = torch.empty(shape, dtype=dtype, device=device)
                for i in range(l):
                    w[i] = normal((din, dout), scale)
                blocks[name] = w
        params["final_norm"] = torch.ones((d,), dtype=dtype, device=device)
        params["lm_head"] = normal((d, v))
        return params

    def _rope_tables(self, device):
        dev = torch.device(device)
        if dev not in self._rope:
            c = self.config
            self._rope[dev] = rope_frequencies(c.head_dim, c.max_seq_len,
                                               c.rope_theta, device=dev)
        return self._rope[dev]

    # ----------------------------------------------------------- forward
    def _block(self, x, blk, cos, sin, cache):
        """One block; with ``cache=(k_full, v_full, layer, idx)`` attention
        runs against the stacked KV cache (written in place)."""
        c = self.config
        b, t, _ = x.shape
        hq, hkv, dh = c.num_heads, c.num_kv_heads, c.head_dim
        idx = cache[3] if cache is not None else 0
        y = rms_norm(x, blk["attn_norm"], c.eps)
        q = qdot("btd,de->bte", y, blk["wq"]).reshape(b, t, hq, dh)
        k = qdot("btd,de->bte", y, blk["wk"]).reshape(b, t, hkv, dh)
        v = qdot("btd,de->bte", y, blk["wv"]).reshape(b, t, hkv, dh)
        q = apply_rotary_pos_emb(q, cos, sin, position_offset=idx)
        k = apply_rotary_pos_emb(k, cos, sin, position_offset=idx)
        if cache is None:
            if hkv != hq:
                k = k.repeat_interleave(hq // hkv, dim=2)
                v = v.repeat_interleave(hq // hkv, dim=2)
            attn = multihead_attention(q, k, v, causal=True)
            kc = vc = None
        else:
            kc, vc, layer, idx = cache
            attn, kc, vc = cached_attention(q, kc, vc, k, v, layer, idx)
        x = x + qdot("bte,ed->btd", attn.reshape(b, t, hq * dh), blk["wo"])
        y = rms_norm(x, blk["mlp_norm"], c.eps)
        gate = F.silu(qdot("btd,dm->btm", y, blk["w_gate"]))
        up = qdot("btd,dm->btm", y, blk["w_up"])
        x = x + qdot("btm,md->btd", gate * up, blk["w_down"])
        return x, kc, vc

    def forward_hidden(self, params, input_ids):
        c = self.config
        x = params["embed"].to(self.compute_dtype)[input_ids]
        cos, sin = self._rope_tables(x.device)
        for layer in range(c.num_layers):
            x = self._block(x, layer_view(params["blocks"], layer), cos, sin,
                            None)[0]
        return rms_norm(x, params["final_norm"], c.eps)

    def logits(self, params, hidden):
        return hidden @ params["lm_head"].to(hidden.dtype)

    # ------------------------------------------------------ inference path
    def init_cache(self, batch_size: int, max_len: int, dtype=None,
                   device=None):
        """Stacked GQA KV cache ``[L, B, Hkv, S, Dh]`` (K and V) plus the
        scalar index 0."""
        c = self.config
        dtype = dtype or self.compute_dtype
        shape = (c.num_layers, batch_size, c.num_kv_heads, max_len, c.head_dim)
        return {"k": alloc_kv_cache(*shape, dtype, device),
                "v": alloc_kv_cache(*shape, dtype, device),
                "index": 0}

    def forward_with_cache(self, params, input_ids, cache):
        """Prefill (T > 1) or decode (T == 1) against the KV cache, written in
        place. ``cache["index"]`` is a python int or a per-slot ``[B]`` int32
        tensor (continuous batching): RoPE then rotates each row at its own
        position and attention masks each row's own prefix."""
        c = self.config
        t = input_ids.shape[1]
        idx = cache["index"]
        x = params["embed"].to(self.compute_dtype)[input_ids]
        cos, sin = self._rope_tables(x.device)
        kc, vc = cache["k"], cache["v"]
        for layer in range(c.num_layers):
            x, kc, vc = self._block(x, layer_view(params["blocks"], layer),
                                    cos, sin, (kc, vc, layer, idx))
        hidden = rms_norm(x, params["final_norm"], c.eps)
        return self.logits(params, hidden), {"k": kc, "v": vc,
                                             "index": idx + t}
