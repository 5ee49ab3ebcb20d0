"""Per-program roofline attribution of the port (port of
deepspeed_tpu/telemetry/attribution.py).

For every program a serving engine runs (prefill buckets, chunk
prefills, decode, speculative verify and draft, swap, block copy) and
for the training step, a row joins the program's FLOPs and bytes with
its host-observed wall per call and places it on the roofline (Williams
et al., 2009)::

    attainable_flops/s = min(peak_flops/s, intensity * peak_bytes/s)

so ``achieved_vs_attainable`` judges each program against the roof that
binds it: a decode step at intensity ~2 flops/byte against the memory
roof, not the matmul peak. The peaks are the accelerator layer's
(``accelerator.card_peaks``, overridden by ``DSTPU_PEAK_TFLOPS`` /
``DSTPU_PEAK_HBM_GBPS``); where one is unknown (the CPU) the row keeps
its flops, bytes, intensity and achieved rates and leaves the attainable
columns None.

The reference takes FLOPs and bytes from XLA's ``cost_analysis`` of each
compiled program, which has no torch counterpart. The port counts them
analytically (:func:`work_cost`) from the model's parameters, its
config, the program's work (``Program.work``: its operand shapes) and,
for the part that depends on the data, the rows the host knows a call
touched. What is counted, per call:

* FLOPs: ``2 * rows * P`` for the weight products, where ``rows`` are
  the token rows the program computes (padding included) and ``P`` the
  elements of every block matmul weight plus the LM head; plus the
  attention products ``4 * layers * q_heads * head_dim`` per (query,
  key) pair, over the causal pairs among the program's new tokens and
  each new token against the context rows already cached (the context
  of the active slots, or a chunk's offset, as the engine noted it).
* Bytes: every weight read once (the parameter tree's bytes, scales of
  int8 weights included, except the token and position embedding tables,
  of which a forward gathers only rows); the K/V rows written (every
  new row) and read (the context rows), at the store's bytes per row in
  every layer (payload and scales); the logits written in the compute
  dtype.
* Nothing else: norms, activations between layers, the embedding rows
  gathered, token ids and lengths are left out, as are rows of inactive
  slots. Every term is work the program cannot avoid, so the count is a
  lower bound and a row never reads above its roof for a count's sake.
* Data movement (swap, block copy): the K/V rows moved, no FLOPs; the
  row is then judged against the memory roof by its bytes.

The count is memoised per program and signature (the reference memoises
its probes): ``attribution_table(..., cache=...)``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

# parameter-tree entries a forward gathers rows of, never reads whole
_GATHERED = ("embed", "wpe")


def roofline_row(flops: float, bytes_accessed: float, *,
                 wall_s: Optional[float] = None, calls: int = 0,
                 peak_flops: Optional[float] = None,
                 peak_bytes_per_sec: Optional[float] = None) -> dict:
    """One attribution-table row. ``wall_s`` is the mean host-observed
    wall per call (None = program never timed); peaks in flops/s and
    bytes/s. ``bound`` names the binding roof at this intensity. A
    program of no FLOPs (data movement) has an attainable rate of 0 and
    is judged by its bytes against the memory roof."""
    intensity = (flops / bytes_accessed) if bytes_accessed else None
    row = {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "intensity_flops_per_byte": (round(intensity, 3)
                                     if intensity is not None else None),
        "calls": int(calls),
        "mean_wall_ms": (round(wall_s * 1e3, 4)
                         if wall_s is not None else None),
        "achieved_tflops": (round(flops / wall_s / 1e12, 4)
                            if wall_s else None),
        "achieved_gbps": (round(bytes_accessed / wall_s / 1e9, 3)
                          if wall_s else None),
        "attainable_tflops": None,
        "achieved_vs_attainable": None,
        "bound": None,
    }
    if intensity is not None and peak_flops and peak_bytes_per_sec:
        attainable = min(peak_flops, intensity * peak_bytes_per_sec)
        row["attainable_tflops"] = round(attainable / 1e12, 4)
        row["bound"] = ("compute" if attainable >= peak_flops
                        else "memory")
        if wall_s:
            row["achieved_vs_attainable"] = round(
                (flops / wall_s) / attainable if attainable
                else (bytes_accessed / wall_s) / peak_bytes_per_sec, 4)
    elif intensity is not None and peak_flops and wall_s:
        # no bandwidth table (override-only setups): plain MFU against
        # the compute roof
        row["attainable_tflops"] = round(peak_flops / 1e12, 4)
        row["bound"] = "compute"
        row["achieved_vs_attainable"] = round(
            (flops / wall_s) / peak_flops, 4)
    return row


def accelerator_peaks(device_name: Optional[str] = None
                      ) -> Tuple[Optional[float], Optional[float]]:
    """(peak flops/s, peak bytes/s) of the card named ``device_name``
    (default: card 0, or the CPU without a card), either None when
    unknown."""
    import torch

    from deepspeed_tpu_torch.accelerator.abstract_accelerator import \
        card_peaks

    if device_name is None:
        device_name = (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu")
    tf, bw = card_peaks(device_name)
    return (tf * 1e12 if tf else None), (bw * 1e9 if bw else None)


class ModelCost(NamedTuple):
    """What :func:`work_cost` needs of a model and its KV store."""

    matmul_params: int          # weight elements one token row multiplies
    weight_bytes: int           # bytes of the weights a forward reads
    attn_flops_per_pair: int    # 4 * layers * q_heads * head_dim
    kv_row_bytes: float         # K and V bytes of one token row, all layers
    logit_row_bytes: int        # vocab * compute-dtype bytes


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, node


def model_cost(params, config, *, kv_row_bytes: float,
               compute_itemsize: int) -> ModelCost:
    """A :class:`ModelCost` from a parameter tree (``blocks/*`` stacked
    ``[L, in, out]`` matmul weights, int8 ones as ``{"__q__", "__scale__"}``;
    ``lm_head [D, V]`` or a tied ``wte [V, D]``) and a model config
    (``num_layers``, ``num_heads``, ``head_dim``, ``vocab_size``)."""
    matmul, wbytes = 0, 0
    for path, t in _leaves(params):
        if path[0] in _GATHERED:
            continue
        wbytes += t.numel() * t.element_size()
        if path[-1] == "__scale__":
            continue
        if path[0] == "blocks" and t.dim() == 3:
            matmul += t.numel()
        elif path[0] == "lm_head" or (path[0] == "wte"
                                      and "lm_head" not in params):
            matmul += t.numel()
    c = config
    return ModelCost(matmul, wbytes, 4 * c.num_layers * c.num_heads * c.head_dim,
                     float(kv_row_bytes), c.vocab_size * compute_itemsize)


def work_cost(model: ModelCost, work: Tuple, rows: float = 0.0
              ) -> Dict[str, float]:
    """FLOPs and bytes of one program call (see the module note).

    ``work`` is the program's ``Program.work``:

    * ``("forward", seqs, tokens)``: ``seqs`` sequences of ``tokens`` new
      rows each; ``rows`` is the context rows they attend to beyond their
      own, summed over the sequences;
    * ``("draft", seqs, window, k)``: a window prefill of ``seqs x
      window`` rows, then ``k - 1`` single-token steps (each counted
      against itself only: their context is not known here);
    * ``("kv", rows_per_call, passes)``: K/V rows moved (plus ``rows``
      moved this call), each touched ``passes`` times (a copy reads and
      writes)."""
    kind = work[0]
    m = model
    if kind == "forward":
        _, seqs, t = work
        n = seqs * t
        pairs = seqs * t * (t + 1) / 2 + t * rows
        flops = 2.0 * n * m.matmul_params + m.attn_flops_per_pair * pairs
        nbytes = (m.weight_bytes + m.kv_row_bytes * (n + rows)
                  + n * m.logit_row_bytes)
    elif kind == "draft":
        _, seqs, w, k = work
        n = seqs * w + (k - 1) * seqs
        pairs = seqs * w * (w + 1) / 2 + (k - 1) * seqs
        flops = 2.0 * n * m.matmul_params + m.attn_flops_per_pair * pairs
        nbytes = k * m.weight_bytes + n * (m.kv_row_bytes + m.logit_row_bytes)
    elif kind == "kv":
        _, static_rows, passes = work
        flops = 0.0
        nbytes = m.kv_row_bytes * (static_rows + rows) * passes
    else:
        raise ValueError(f"unknown program work {work!r}")
    return {"flops": float(flops), "bytes_accessed": float(nbytes)}


def program_cost(fn: Callable, args: Tuple) -> Dict[str, float]:
    """The count ``fn(*args)`` of one program: ``{"flops": ...,
    "bytes_accessed": ...}`` (the reference's probe lowers and compiles;
    here ``fn`` is an analytic count such as :func:`work_cost`)."""
    cost = fn(*args)
    return {"flops": float(cost["flops"]),
            "bytes_accessed": float(cost["bytes_accessed"])}


def attribution_table(programs: Dict[str, Tuple], *,
                      walls: Optional[Dict[str, Tuple[float, int]]] = None,
                      cache: Optional[Dict[Tuple, dict]] = None,
                      device_name: Optional[str] = None) -> dict:
    """Roofline table over named programs.

    ``programs``: name -> (count_fn, args), the count of one call being
    ``count_fn(*args)``. ``walls``: name -> (total wall seconds, calls)
    observed on the host. ``cache``: optional dict the caller owns; the
    counts are memoised there per (name, args)."""
    peak_flops, peak_bw = accelerator_peaks(device_name)
    walls = walls or {}
    out: Dict[str, dict] = {}
    for name in sorted(programs):
        fn, args = programs[name]
        key = (name, args)
        cost = cache.get(key) if cache is not None else None
        if cost is None:
            cost = program_cost(fn, args)
            if cache is not None:
                cache[key] = cost
        total_s, calls = walls.get(name, (0.0, 0))
        out[name] = roofline_row(
            cost["flops"], cost["bytes_accessed"],
            wall_s=(total_s / calls) if calls else None, calls=calls,
            peak_flops=peak_flops, peak_bytes_per_sec=peak_bw)
    return out
