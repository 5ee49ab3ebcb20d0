"""Rehearse chip_smoke.py's ``serve_fabric`` phase and its fp32 fabric
check on the CPU, at tiny widths, before spending chip time.

    python3 scripts/rehearse_serve_fabric.py [bf16|fp32]

A 2-layer, hidden-128 LLaMA of vocab 32000 runs the phase's functions
unchanged on the plain versions of the kernels. The card-only calls are
stubbed (no sync, 0 bytes allocated), the plain fused decode step bumps
its wrapper's launch counter, and a decode program's call with a new
signature counts as a capture, so the phase's launch hold is exercised.
Every request runs to its token budget (no EOS), so the virtual timeline
(counters, alerts, scale decisions) is the one a card run gives; times
are the CPU's and say nothing of the card.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

torch.set_num_threads(1)
torch.cuda.memory_allocated = lambda *a, **k: 0
torch.cuda.synchronize = lambda *a, **k: None
torch.cuda.empty_cache = lambda *a, **k: None

import deepspeed_tpu_torch  # noqa: E402
import deepspeed_tpu_torch.ops.decode_step as decode_step  # noqa: E402
from deepspeed_tpu_torch.inference import programs  # noqa: E402
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel  # noqa: E402

_plain = decode_step.fused_decode_step_plain
_call = programs.GraphProgram.__call__


def _counted(*args, **kw):
    decode_step.fused_decode_step.launches += 1
    return _plain(*args, **kw)


def _capturing(self, *args):
    if self.signature(args) not in self._entries:
        self.captures += 1
    return _call(self, *args)


def main() -> int:
    decode_step.fused_decode_step_plain = _counted
    programs.GraphProgram.__call__ = _capturing
    import chip_smoke

    cfg = LlamaConfig(vocab_size=32000, max_seq_len=2048, num_layers=2,
                      hidden_size=128, num_heads=4, num_kv_heads=4,
                      intermediate_size=256)
    dtype = sys.argv[1] if len(sys.argv) > 1 else "bf16"
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(cfg), dtype=dtype,
                                             device="cpu", seed=0)
    chip_smoke.phase_serve_fabric(eng, "cpu rehearsal", sync=lambda: None)
    fp32 = deepspeed_tpu_torch.init_inference(LlamaModel(cfg), dtype="fp32",
                                              device="cpu", seed=0)
    print({"fabric_fp32": chip_smoke.fabric_fp32_check(fp32),
           "wall_s": time.perf_counter() - t0}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
