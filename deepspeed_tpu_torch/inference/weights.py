"""Weight bridge: a JAX ``LlamaModel`` parameter tree (nested dicts of numpy
arrays, e.g. ``jax.device_get(engine.params)``) to the port's parameters.

The JAX layout and orientation are kept (``embed [V, D]``, stacked
``blocks/* [L, in, out]``, ``final_norm``, ``lm_head [D, V]``), so the
bridge is a copy. Weight-only int8 leaves ``{"__q__", "__scale__"}`` are
carried as they are (int8 values, f32 scales), so both engines can serve
the identical quantized weights. numpy bfloat16 arrays (the ``ml_dtypes``
type JAX hands out) are reinterpreted bit for bit."""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
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
