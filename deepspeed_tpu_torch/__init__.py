"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` stays the reference; this package mirrors
its module paths and public names and imports nothing from it (and no
``jax``). Its entry points run on the CUDA card unless the caller asks for
the CPU (``device="cpu"``), where every kernel wrapper takes its plain
PyTorch version.

    engine = init_inference(LlamaModel(LlamaConfig.llama_7b()), dtype="bf16")
    results = ServingEngine(engine, num_slots=8, max_len=1024,
                            buckets=(128, 512)).run(requests)
"""

from __future__ import annotations

from deepspeed_tpu_torch.accelerator import DeviceUnavailableError, get_accelerator  # noqa: F401
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel  # noqa: F401
from deepspeed_tpu_torch.serving import Request, RequestResult, ServingEngine  # noqa: F401
from deepspeed_tpu_torch.utils.logging import log_dist, logger  # noqa: F401

__version__ = "0.1.0"


def init_inference(model=None, config=None, *, device=None, params=None,
                   **kwargs) -> InferenceEngine:
    """Inference engine factory (the JAX package's ``init_inference``).

    ``config`` is a dict of DeepSpeedInferenceConfig keys or an instance;
    keyword arguments are merged into it. ``device`` None means the CUDA
    card (raising :class:`DeviceUnavailableError` when there is none);
    ``params`` takes a ready parameter dict, e.g. from
    ``inference.weights.llama_params_from_numpy``."""
    if config is None:
        config = kwargs
    elif kwargs:
        config = {**(config if isinstance(config, dict) else {}), **kwargs}
    if not isinstance(config, DeepSpeedInferenceConfig):
        config = DeepSpeedInferenceConfig.from_dict(config)
    return InferenceEngine(model, config, params=params, device=device)
