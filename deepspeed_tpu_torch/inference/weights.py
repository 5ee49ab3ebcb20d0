"""State bridge from the JAX package (numpy arrays, e.g. from
``jax.device_get``) to the port.

``llama_params_from_numpy``: a JAX ``LlamaModel`` parameter tree. The JAX
layout and orientation are kept (``embed [V, D]``, stacked ``blocks/* [L,
in, out]``, ``final_norm``, ``lm_head [D, V]``), so the bridge is a copy.
Weight-only int8 leaves ``{"__q__", "__scale__"}`` are carried as they are
(int8 values, f32 scales), so both engines can serve the identical
quantized weights.

``gpt2_params_from_numpy`` / ``numpy_from_params``: a JAX ``GPT2Model``
parameter tree (the same layout in both packages) to the port and back, so
tests can start both from one init and compare parameters after training.

``kv_pool_from_numpy``: a JAX block pool (possibly token-pair packed,
possibly a quantized ``{"q", "s"}`` pool with pair-grouped scales) in the
port's logical layout, so tests can hand both packages the same pool.

numpy bfloat16 and float8_e4m3fn arrays (the ``ml_dtypes`` types JAX hands
out) are reinterpreted bit for bit."""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(np.array(a).view(np.uint8)).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(np.array(a))
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def llama_params_from_numpy(tree, device, dtype):
    """Convert a JAX LLaMA params tree. Float leaves are cast to ``dtype``
    (the serving dtype); int8 dict leaves keep int8 values and f32 scales."""

    def walk(node):
        if isinstance(node, dict):
            if "__q__" in node:
                return {"__q__": _to_tensor(node["__q__"], device),
                        "__scale__": _to_tensor(node["__scale__"], device,
                                                torch.float32)}
            return {k: walk(v) for k, v in node.items()}
        return _to_tensor(node, device, dtype)

    return walk(tree)


def gpt2_params_from_numpy(tree, device, dtype=torch.float32):
    """Copy a JAX GPT-2 params tree (numpy leaves) to ``device`` in
    ``dtype`` (float32: the training engine's master parameters)."""
    if isinstance(tree, dict):
        return {k: gpt2_params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return _to_tensor(tree, device, dtype)


def numpy_from_params(tree):
    """The way back: every leaf as a float32 numpy array on the host."""
    if isinstance(tree, dict):
        return {k: numpy_from_params(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def kv_pool_from_numpy(pool, head_dim: int, device):
    """One JAX block pool in the port's logical layout. The payload
    ``[L, N+1, Hkv, bs/pair, Dh*pair]`` is a row-major view of
    ``[L, N+1, Hkv, bs, Dh]``; pair-grouped scales ``[L, N+1, Hkv, pair,
    bs/pair]`` (token ``t`` at ``[..., t % pair, t // pair]``) become
    token-ordered ``[L, N+1, Hkv, bs]``. Values are copied bit for bit."""
    if isinstance(pool, dict):
        q = np.asarray(pool["q"])
        s = np.asarray(pool["s"])
        l, n, hkv, pair, bsp = s.shape
        return {"q": _to_tensor(q.reshape(l, n, hkv, pair * bsp, head_dim),
                                device),
                "s": _to_tensor(np.ascontiguousarray(
                    np.swapaxes(s, -2, -1)).reshape(l, n, hkv, pair * bsp),
                    device)}
    a = np.asarray(pool)
    l, n, hkv, bsp, dhp = a.shape
    return _to_tensor(a.reshape(l, n, hkv, bsp * (dhp // head_dim), head_dim),
                      device)
