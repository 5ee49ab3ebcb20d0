"""FLOPs profiler (port of deepspeed_tpu/profiling/flops_profiler.py) —
analog of reference ``deepspeed/profiling/flops_profiler/profiler.py``
(FlopsProfiler:23, get_model_profile:1103).

The JAX package reads XLA's own count of a compiled program; here the
count is taken by running the function once under
``torch.utils.flop_counter.FlopCounterMode`` (the products torch
dispatches: matmuls, einsums, SDPA, convolutions; two operations per
multiply-add), plus the work each hand-written kernel reports
(ops/kernel_flops.py): a ctypes launch is invisible to the dispatcher, and
on the CPU a kernel's plain version is taken back out of the dispatch
count, so the same model and batch give the same total on the CPU and on
the card. Elementwise work (norms, softmax, activations) is not counted,
and every layer is counted: there is no scanned body counted once.

API as the reference's: ``FlopsProfiler`` with ``start_profile`` /
``stop_profile`` / ``profile_fn`` / ``get_total_flops`` /
``get_total_params`` / ``get_total_duration`` / ``print_model_profile``,
and ``get_model_profile(model, batch)`` → ``(flops, macs, params)``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.kernel_flops import kernel_flops_counter
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map


def _fmt_flops(f: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(f) < 1000:
            return f"{f:.2f} {unit}FLOPs"
        f /= 1000
    return f"{f:.2f} EFLOPs"


def _fmt_params(n: float) -> str:
    for unit in ("", "k", "M", "B", "T"):
        if abs(n) < 1000:
            return f"{n:.2f} {unit}"
        n /= 1000
    return f"{n:.2f} Q"


def count_flops(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and count its FLOPs: ``flops`` (the
    total), ``dispatch_flops`` (what torch dispatched outside the kernels'
    plain versions), ``kernel_flops`` (name → FLOPs reported by the
    hand-written kernels' wrappers) and ``out``, the function's result."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as mode:
        with kernel_flops_counter(probe=mode.get_total_flops) as kc:
            out = fn(*args, **kwargs)
    dispatch = float(mode.get_total_flops()) - kc.hidden
    return {"flops": dispatch + kc.total, "dispatch_flops": dispatch,
            "kernel_flops": dict(kc.kernels), "out": out}


def _param_count(model) -> int:
    """Parameters of ``model.init`` without allocating them (meta tensors)."""
    params = model.init(torch.Generator(), device="meta", dtype=torch.float32)
    return sum(t.numel() for t in tree_leaves(params))


class FlopsProfiler:
    """The reference FlopsProfiler:23 API over :func:`count_flops`."""

    def __init__(self, model=None, ds_engine=None):
        self.model = model
        self.ds_engine = ds_engine
        self._cost: Dict[str, Any] = {}
        self._params: Optional[int] = None
        self._t0: Optional[float] = None
        self._duration = 0.0
        self.started = False

    def start_profile(self, ignore_list=None):
        self.started = True
        self._t0 = time.time()

    def stop_profile(self):
        if self._t0 is not None:
            self._duration = time.time() - self._t0
        self.started = False

    def profile_fn(self, fn, *args):
        """Count ``fn(*args)`` (run once); returns the count without the
        function's result."""
        cost = count_flops(fn, *args)
        cost.pop("out")
        self._cost = cost
        return cost

    # ---- totals (reference get_total_* API)
    def get_total_flops(self, as_string: bool = False):
        f = self._cost.get("flops", 0.0)
        return _fmt_flops(f) if as_string else f

    def get_total_duration(self, as_string: bool = False):
        return f"{self._duration:.2f} s" if as_string else self._duration

    def get_total_params(self, as_string: bool = False):
        n = self._params
        if n is None:
            if self.ds_engine is not None:
                n = sum(t.numel() for t in tree_leaves(self.ds_engine.state.params))
            elif self.model is not None and hasattr(self.model, "init"):
                n = _param_count(self.model)
            self._params = n
        n = n or 0
        return _fmt_params(float(n)) if as_string else n

    def print_model_profile(self, profile_step=1, module_depth=-1, top_modules=1,
                            detailed=True, output_file=None):
        kernels = self._cost.get("kernel_flops", {})
        lines = [
            "-------------------------- DeepSpeed-TPU (PyTorch) Flops "
            "Profiler --------------------------",
            f"params:                 {self.get_total_params(as_string=True)}",
            f"flops (counted):        {self.get_total_flops(as_string=True)}",
            f"  dispatched by torch:  "
            f"{_fmt_flops(self._cost.get('dispatch_flops', 0.0))}",
        ] + [f"  kernel {name}: {_fmt_flops(f)}"
             for name, f in sorted(kernels.items())] + [
            "bytes accessed:         not counted",
            f"profile duration:       {self.get_total_duration(as_string=True)}",
        ]
        text = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as f:
                f.write(text + "\n")
        else:
            print(text)
        return text

    def end_profile(self):
        self.stop_profile()


def get_model_profile(model, batch, *, params=None, generator=None,
                      device=None, as_string: bool = True,
                      print_profile: bool = False) -> Tuple[Any, Any, Any]:
    """One forward of ``model.apply(params, batch, train=False)`` counted:
    ``(flops, macs, params)`` as the reference's get_model_profile:1103
    (``macs`` is flops / 2). ``params`` default to ``model.init`` from
    ``generator`` (seed 0) on the batch's device; a batch of arrays goes to
    ``device`` (default: the card)."""
    first = next(iter(batch.values())) if isinstance(batch, dict) else batch
    if isinstance(first, torch.Tensor):
        dev = first.device
    else:
        from deepspeed_tpu_torch.accelerator import get_accelerator

        dev = get_accelerator(device).device()
        batch = tree_map(lambda x: torch.as_tensor(x).long().to(dev), batch)
    if params is None:
        gen = generator or torch.Generator(device=dev).manual_seed(0)
        params = model.init(gen, device=dev, dtype=torch.float32)
    prof = FlopsProfiler(model=model)
    prof._params = sum(t.numel() for t in tree_leaves(params))
    prof.start_profile()
    with torch.no_grad():
        prof.profile_fn(lambda p, b: model.apply(p, b, rngs=None,
                                                 train=False)[0],
                        params, batch)
    prof.stop_profile()
    if print_profile:
        prof.print_model_profile()
    flops = prof.get_total_flops()
    macs = flops / 2.0
    n_params = prof.get_total_params()
    if as_string:
        return (_fmt_flops(flops), _fmt_params(macs) + "MACs",
                _fmt_params(float(n_params)))
    return flops, macs, n_params
