"""The compile-once contract of the port: the part ``jax.jit`` plays in the
JAX package's inference and serving engines.

:class:`Program` keys its entries by the signature of its operands (every
tensor's shape, dtype and device; a generator's device; a python scalar's
type), as jit's cache keys its compiled entries, and runs its closure
eagerly. ``_cache_size()`` is the entry count the reference reads
(``InferenceEngine.jit_cache_sizes``, ``ServingEngine.program_cache_sizes``):
a second entry means an operand's shape or dtype varied.

:class:`GraphProgram` is the same contract for a decode program, which runs
once per token, held by whatever owns the buffers it reads (a serving
engine's KV store, a generate shape's cache): on a CUDA device the first
call with a new signature runs the closure once eagerly on a side stream
(the real step: it builds the kernels and sets their attributes, and its
outputs are the call's), then captures it into one ``torch.cuda.CUDAGraph``
in a memory pool that every graph of one inference engine shares, without
running it; later calls replay. Python scalars are constants of a graph,
so their values enter its signature. On the CPU nothing is captured: the
closure runs eagerly and its entries are counted all the same. A capture
that fails raises; nothing falls back to eager launches on the card.

Operands of a graph program are of two kinds:

* per-step inputs (``inputs``, positional indices): a call whose input
  lies elsewhere than the captured one is copied into the captured buffer
  before the replay;
* persistent operands (everything else: parameters, caches, lengths,
  block tables): a replay reads the addresses baked in at capture, so a
  call whose persistent tensor lies elsewhere raises.

A ``torch.Generator`` operand is replaced in the graph by a generator the
graph owns (registered with it): each replay starts from the caller's seed
and offset and hands the advanced offset back, so a replay draws the bits
the eager closure would draw from the same generator.

Launch counters (the kernel wrappers' ``launches`` attributes) count
kernel launches: the first call's eager run counts its own, the increase
seen during capture is taken back (a capture launches nothing) and added
again on every replay.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


def _flatten(obj, leaves: List) -> object:
    """Leaves of nested dicts, lists and tuples in order, and the
    structure to rebuild them (:func:`_unflatten`)."""
    if isinstance(obj, dict):
        return ("dict", [(k, _flatten(v, leaves)) for k, v in obj.items()])
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, [_flatten(v, leaves) for v in obj])
    leaves.append(obj)
    return ("leaf", len(leaves) - 1)


def _unflatten(spec, leaves: Sequence):
    kind, body = spec
    if kind == "leaf":
        return leaves[body]
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in body}
    items = [_unflatten(s, leaves) for s in body]
    return items if kind == "list" else tuple(items)


def _structure(spec):
    """The part of a flatten spec that belongs in a signature (dict keys
    and container kinds, not leaf positions)."""
    kind, body = spec
    if kind == "leaf":
        return None
    if kind == "dict":
        return ("dict", tuple((k, _structure(s)) for k, s in body))
    return (kind, tuple(_structure(s) for s in body))


def launch_counters() -> List[Callable]:
    """The kernel wrappers whose ``launches`` attribute counts their
    launches (every hand-written kernel of the port)."""
    from deepspeed_tpu_torch.ops.decode_step import (fused_block_decode_step,
                                                     fused_decode_step)
    from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_dkv,
                                                         flash_bwd_dq,
                                                         flash_fwd_parts)
    from deepspeed_tpu_torch.ops.flash_decode import (flash_decode,
                                                      flash_decode_mha)
    from deepspeed_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_dma
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import (
        block_sparse_bwd_dkv, block_sparse_bwd_dq, block_sparse_fwd)

    return [fused_decode_step, fused_block_decode_step, int8_matmul_dma,
            int8_matmul, flash_decode, flash_decode_mha, flash_fwd_parts,
            flash_bwd_dq, flash_bwd_dkv, block_sparse_fwd, block_sparse_bwd_dq,
            block_sparse_bwd_dkv]


class Program:
    """A closure with jit's entry accounting (see the module note). The
    closure is ``eager``; ``inputs`` are the positional indices of its
    per-step inputs (what a :class:`GraphProgram` of it copies in);
    ``work`` describes one call's work from its operand shapes for the
    roofline count (telemetry/attribution.work_cost), None where none is
    kept."""

    def __init__(self, fn: Callable, name: str, *, inputs: Sequence[int] = (),
                 work: Optional[Tuple] = None):
        self.eager = fn
        self.name = name
        self.inputs = frozenset(inputs)
        self.work = work
        self._entries: Dict[Tuple, object] = {}

    def _leaf_signature(self, x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.dtype, x.device)
        if isinstance(x, torch.Generator):
            return ("generator", x.device)
        if x is None or isinstance(x, (bool, int, float)):
            return type(x).__name__        # jit's weakly typed scalars
        return ("static", x)

    def signature(self, args: Tuple) -> Tuple:
        leaves: List = []
        spec = _flatten(args, leaves)
        return (_structure(spec),) + tuple(self._leaf_signature(x)
                                           for x in leaves)

    def _cache_size(self) -> int:
        return len(self._entries)

    def note(self, args: Tuple) -> None:
        """Count ``args``' signature as an entry."""
        self._entries.setdefault(self.signature(args), None)

    def __call__(self, *args):
        self.note(args)
        return self.eager(*args)


class GraphPool:
    """The CUDA graph memory pool that one engine's graph programs share
    (they never run at once); made at the first capture.

    A capture may join a pool only while a graph captured into it lives:
    once every such graph is freed, PyTorch's allocator keeps the pool
    until its memory is released and refuses to capture into it (an
    internal assert). So the handle is renewed when no graph of the pool is
    alive (a serving engine dropped before the next one captures)."""

    def __init__(self):
        self._handle = None
        self._graphs: "weakref.WeakSet" = weakref.WeakSet()

    def handle(self):
        if self._handle is None or not len(self._graphs):
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def add(self, graph) -> None:
        """Record a graph captured into the pool."""
        self._graphs.add(graph)


class _Captured:
    """One captured signature: the graph, the persistent operands'
    addresses, the per-step inputs' buffers, the outputs, the generators
    the graph owns and the launch counters' increase per replay."""

    __slots__ = ("graph", "addresses", "inputs", "out_spec", "out_leaves",
                 "generators", "launches")


class GraphProgram(Program):
    """A decode program: one CUDA graph per signature on the card (see the
    module note) of ``program``'s closure, with its name and per-step
    inputs. Every signature met here is also counted in ``program`` (the
    engine's entry, which ``jit_cache_sizes`` reads); the graphs belong to
    this object, and go with it. ``pool`` is the engine's
    :class:`GraphPool`."""

    def __init__(self, program: Program, pool: GraphPool):
        super().__init__(program.eager, program.name, inputs=program.inputs)
        self.program = program
        self.pool = pool
        self.captures = 0

    def _leaf_signature(self, x):
        if isinstance(x, (bool, int, float)):
            return (type(x).__name__, x)   # a constant of the graph
        return super()._leaf_signature(x)

    @staticmethod
    def _on_card(args) -> bool:
        leaves: List = []
        _flatten(args, leaves)
        return any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves)

    def __call__(self, *args):
        sig = self.signature(args)
        entry = self._entries.get(sig)
        if entry is not None:
            return self._replay(entry, args)
        if sig not in self._entries:
            self.program.note(args)
        if not self._on_card(args):
            self._entries[sig] = None
            return self.eager(*args)
        return self._capture(sig, args)

    # ------------------------------------------------------------- capture
    def _split(self, args):
        """Per argument: its flattened leaves."""
        out = []
        for a in args:
            leaves: List = []
            _flatten(a, leaves)
            out.append(leaves)
        return out

    def _capture(self, sig, args):
        """Run the step for real on a side stream (which builds the kernels
        and sets their attributes off the capture: a graph may not record
        those calls), then capture it without running it. Returns the real
        run's outputs."""
        per_arg = self._split(args)
        device = next(x.device for leaves in per_arg for x in leaves
                      if isinstance(x, torch.Tensor) and x.is_cuda)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            outs = self.eager(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)

        entry = _Captured()
        entry.generators = {}
        call = list(args)
        for i, a in enumerate(args):
            if isinstance(a, torch.Generator):
                own = torch.Generator(device=a.device)
                own.manual_seed(a.initial_seed())
                entry.generators[i] = own
                call[i] = own
        graph = torch.cuda.CUDAGraph()
        for own in entry.generators.values():
            graph.register_generator_state(own)
        counters = launch_counters()
        before = [f.launches for f in counters]
        with torch.cuda.graph(graph, pool=self.pool.handle()):
            graph_outs = self.eager(*call)
        entry.launches = [(f, f.launches - n)
                          for f, n in zip(counters, before) if f.launches != n]
        for f, n in zip(counters, before):
            f.launches = n
        entry.graph = graph
        self.pool.add(graph)
        entry.addresses = [
            (i, j, x.data_ptr()) for i, leaves in enumerate(per_arg)
            if i not in self.inputs
            for j, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        entry.inputs = {i: per_arg[i] for i in self.inputs if i < len(args)}
        # outputs that are operands are handed back as the caller's
        # operands, not kept alive here
        out_leaves: List = []
        entry.out_spec = _flatten(graph_outs, out_leaves)
        operand = {id(x): (i, j) for i, leaves in enumerate(per_arg)
                   for j, x in enumerate(leaves)
                   if isinstance(x, torch.Tensor)}
        entry.out_leaves = [("operand", operand[id(x)]) if id(x) in operand
                            else ("own", x) for x in out_leaves]
        self._entries[sig] = entry
        self.captures += 1
        return outs

    # -------------------------------------------------------------- replay
    def _replay(self, entry: _Captured, args):
        per_arg = self._split(args)
        for i, j, ptr in entry.addresses:
            if per_arg[i][j].data_ptr() != ptr:
                raise RuntimeError(
                    f"{self.name}: persistent operand {i} (leaf {j}) lies at "
                    f"{per_arg[i][j].data_ptr():#x}, but the program's CUDA "
                    f"graph was captured reading {ptr:#x}; keep caches, "
                    "lengths, block tables and parameters in place")
        for i, statics in entry.inputs.items():
            for static, x in zip(statics, per_arg[i]):
                if x.data_ptr() != static.data_ptr():
                    static.copy_(x, non_blocking=True)
        for i, own in entry.generators.items():
            own.manual_seed(args[i].initial_seed())
            own.set_offset(args[i].get_offset())
        entry.graph.replay()
        for i, own in entry.generators.items():
            args[i].set_offset(own.get_offset())
        for f, n in entry.launches:
            f.launches += n
        return _unflatten(entry.out_spec, [
            per_arg[ref[0]][ref[1]] if kind == "operand" else ref
            for kind, ref in entry.out_leaves])
