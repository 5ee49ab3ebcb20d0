"""Activation checkpointing (port of
deepspeed_tpu/runtime/activation_checkpointing.py).

The reference maps every option onto a ``jax.checkpoint`` policy: what the
backward may keep from the forward, everything else recomputed. Here the
same named policies run on ``torch.utils.checkpoint`` (non-reentrant):

* ``None`` / ``"nothing"``: keep only the wrapped function's inputs and
  recompute the rest in the backward (classic full remat).
* ``"everything"``: keep everything (no recompute).
* ``"dots"`` / ``"checkpoint_dots"``: keep the output of every matrix
  product (``aten.mm`` / ``addmm`` / ``bmm`` / ``baddbmm``), by PyTorch's
  selective checkpointing (``create_selective_checkpoint_contexts``).
* ``"dots_no_batch"``: keep the products with no batch dimension, the
  weight matmuls (an einsum against a weight lowers to ``bmm`` with batch
  1; attention's batched products are recomputed).
* ``"offload_dots"``: as ``"dots_no_batch"``, with the kept outputs held in
  pinned host memory until the backward (the reference's
  ``offload_dot_with_no_batch_dims``; ``cpu_checkpointing`` selects it).
  Selective checkpointing keeps its outputs where they were made, so this
  policy has a pair of dispatch modes of its own.
* ``"save_attn"``: ``"dots_no_batch"`` plus the flash call's residuals (q,
  k, v, output and log-sum-exp: the reference's ``flash_res``), so that
  the backward never runs the flash forward kernel again. A model block
  given to :func:`checkpoint_block` runs as two rematerialised parts with
  attention between them, outside any checkpointed region, where the
  flash autograd function keeps its own residuals. A function given whole
  to :func:`checkpoint_wrapper` has no such seam, and keeps only its
  products.

Recompute replays the wrapped function's ``torch.Generator`` arguments from
their state at the forward, so dropout sees the same masks (the reference
gets this from JAX's functional keys).

``configure()`` / ``is_configured()`` / ``get_config()`` mirror the
reference's module-level API. As in the reference the training engine
does not call ``configure``: the ``activation_checkpointing`` section of an
engine config is parsed and not read, and ``partition_activations``,
``contiguous_memory_optimization``, ``number_checkpoints``,
``synchronize_checkpoint_boundary`` and ``profile`` change nothing on one
device. ``checkpoint_policy(None)`` reads the configured
``cpu_checkpointing`` and ``policy``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, NamedTuple, Optional

import torch
import torch.utils.checkpoint as torch_checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

_config = None


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    global _config
    if deepspeed_config is not None:
        _config = deepspeed_config.activation_checkpointing_config
    else:
        from deepspeed_tpu_torch.runtime.config import ActivationCheckpointingConfig

        _config = ActivationCheckpointingConfig(
            partition_activations=bool(partition_activations),
            cpu_checkpointing=bool(checkpoint_in_cpu),
            contiguous_memory_optimization=bool(contiguous_checkpointing),
            number_checkpoints=num_checkpoints,
            synchronize_checkpoint_boundary=bool(synchronize),
            profile=bool(profile),
        )


def is_configured() -> bool:
    return _config is not None


def get_config():
    return _config


class RematPolicy(NamedTuple):
    """What a selective policy keeps: matrix products (all, or only those
    without a batch dimension), whether kept products wait in host memory,
    and whether a block's attention runs between its rematerialised parts
    (:func:`checkpoint_block`)."""

    name: str
    dots: bool = False
    batched_dots: bool = False
    offload: bool = False
    attention: bool = False

    def saves(self, func, args) -> bool:
        if not self.dots:
            return False
        if func in _MM:
            return True
        lhs = _BMM.get(func)
        if lhs is None:
            return False
        return self.batched_dots or args[lhs].shape[0] == 1


_MM = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))
# batched products, by the position of their left operand
_BMM = {torch.ops.aten.bmm.default: 0, torch.ops.aten.baddbmm.default: 1}


_DOTS = RematPolicy("dots", dots=True, batched_dots=True)
_DOTS_NO_BATCH = RematPolicy("dots_no_batch", dots=True)
POLICIES = {
    None: None,                     # save nothing: classic full remat
    "nothing": None,
    "everything": RematPolicy("everything"),
    "dots": _DOTS,
    "dots_no_batch": _DOTS_NO_BATCH,
    "checkpoint_dots": _DOTS._replace(name="checkpoint_dots"),
    "offload_dots": _DOTS_NO_BATCH._replace(name="offload_dots", offload=True),
    "save_attn": _DOTS_NO_BATCH._replace(name="save_attn", attention=True),
}


def checkpoint_policy(name: Optional[str] = None) -> Optional[RematPolicy]:
    """Named policy -> :class:`RematPolicy` (None = save nothing). With no
    name, the configured ``cpu_checkpointing`` / ``policy`` choose, as in
    the reference."""
    if name is None and _config is not None:
        if _config.cpu_checkpointing:
            name = "offload_dots"
        elif _config.policy:
            name = _config.policy
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy '{name}'; known: "
                         f"{sorted(k for k in POLICIES if k)}")
    return POLICIES[name]


# ------------------------------------------------------- offload modes
def _keep(out):
    """A kept output: copied into pinned host memory (detached where it
    already lies on the host)."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach()
        if t.device.type == "cpu":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return (host.copy_(t, non_blocking=True), t.device)

    return tree_map(one, out)


def _give_back(kept):
    def one(x):
        if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.device):
            return x[0].to(x[1], non_blocking=True)
        return x

    return tree_map(one, kept, is_leaf=lambda x: isinstance(x, tuple)
                    and len(x) == 2 and isinstance(x[1], torch.device))


class _Kept:
    def __init__(self):
        self.outputs: List[Any] = []
        self.next = 0


class _SaveMode(TorchDispatchMode):
    """Forward: run every op, and move the outputs the policy saves to the
    host."""

    def __init__(self, policy: RematPolicy, kept: _Kept):
        super().__init__()
        self.policy, self.kept = policy, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.policy.saves(func, args):
            self.kept.outputs.append(_keep(out))
        return out


class _ReplayMode(TorchDispatchMode):
    """Recompute: hand back the kept outputs, in order and on their device
    again, in place of the ops that made them; run every other op."""

    def __init__(self, policy: RematPolicy, kept: _Kept):
        super().__init__()
        self.policy, self.kept = policy, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.policy.saves(func, args):
            out = self.kept.outputs[self.kept.next]
            self.kept.next += 1
            return _give_back(out)
        return func(*args, **(kwargs or {}))


def _replaying_generators(function: Callable, args) -> Callable:
    """``function`` whose second and later calls (the recompute) run with
    the ``torch.Generator`` arguments set back to their state at the first
    call, and left as they were found afterwards."""
    gens = [a for a in args if isinstance(a, torch.Generator)]
    if not gens:
        return function
    at_forward = [g.get_state() for g in gens]
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, at_forward):
            g.set_state(s)
        try:
            return function(*a)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    return run


def _sac_policy(policy: RematPolicy, ctx, func, *args, **kwargs):
    if policy.saves(func, args):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(function: Callable, policy: Optional[RematPolicy], args):
    if policy is not None and policy.name == "everything":
        return function(*args)
    run = _replaying_generators(function, args)
    if policy is None:
        return torch_checkpoint.checkpoint(run, *args, use_reentrant=False,
                                           preserve_rng_state=False)
    if policy.offload:
        def contexts():
            kept = _Kept()
            return _SaveMode(policy, kept), _ReplayMode(policy, kept)
    else:
        contexts = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            functools.partial(_sac_policy, policy))
    return torch_checkpoint.checkpoint(run, *args, use_reentrant=False,
                                       preserve_rng_state=False,
                                       context_fn=contexts)


def checkpoint(function: Callable, *args):
    """Drop-in for the reference's ``checkpoint(function, *args)``:
    ``function(*args)`` under the configured policy (save nothing when not
    configured)."""
    return _remat(function, checkpoint_policy(None) if _config else None, args)


def checkpoint_wrapper(function: Callable, policy: Optional[str] = None,
                       prevent_cse: bool = True, static_argnums=()) -> Callable:
    """``function`` rematerialised under the named policy. ``prevent_cse``
    and ``static_argnums`` are JAX tracing options with nothing to do
    here."""
    del prevent_cse, static_argnums
    resolved = checkpoint_policy(policy)
    return lambda *args: _remat(function, resolved, args)


def checkpoint_block(pre: Callable, attend: Callable, post: Callable,
                     policy: Optional[str] = None) -> Callable:
    """A transformer block ``x, *a -> post(x, attend(*pre(x, *a), *a), *a)``
    (``pre`` gives attention's operands, ``post`` the block's output from
    attention's) rematerialised under the named policy. Under
    ``"save_attn"`` ``pre`` and ``post`` are rematerialised as
    ``"dots_no_batch"`` and ``attend`` runs between them, outside both, so
    that its autograd function keeps its own residuals and the backward
    does not run it again. Any other policy rematerialises the whole
    block."""
    resolved = checkpoint_policy(policy)
    if resolved is None or not resolved.attention:
        return lambda x, *a: _remat(
            lambda x, *a: post(x, attend(*pre(x, *a), *a), *a), resolved,
            (x,) + a)
    parts = resolved._replace(attention=False)

    def block(x, *a):
        ops = _remat(pre, parts, (x,) + a)
        return _remat(post, parts, (x, attend(*ops, *a)) + a)

    return block
