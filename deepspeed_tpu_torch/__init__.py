"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` stays the reference; this package mirrors
its module paths and public names and imports nothing from it (and no
``jax``). Its entry points run on the CUDA card unless the caller asks for
the CPU (``device="cpu"``), where every kernel wrapper takes its plain
PyTorch version.

    engine = init_inference(LlamaModel(LlamaConfig.llama_7b()), dtype="bf16")
    results = ServingEngine(engine, num_slots=8, max_len=1024,
                            buckets=(128, 512)).run(requests)

    engine, *_ = initialize(model=GPT2Model(GPT2Config.gpt2_774m(),
                                            attn_impl="flash"),
                            config={"train_batch_size": 16, ...})
    loss = engine.train_batch_from_stacked(batch)   # [gas, B, T] arrays
"""

from __future__ import annotations

from deepspeed_tpu_torch.accelerator import DeviceUnavailableError, get_accelerator  # noqa: F401
from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model  # noqa: F401
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel  # noqa: F401
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
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


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config=None,
               config_params=None, *, collate_fn=None, device=None,
               params=None):
    """Initialize the training engine (the JAX package's ``initialize``).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    ``config`` is a dict, a JSON path or a :class:`DeepSpeedConfig` (world
    size 1). ``device`` None means the CUDA card (raising
    :class:`DeviceUnavailableError` when there is none); ``params`` takes a
    ready parameter dict (e.g. ``inference.weights.gpt2_params_from_numpy``)
    instead of the model's seeded init. A pipeline module or an enabled
    ``hybrid_engine`` raises :class:`NotPortedError`."""
    assert model is not None, "deepspeed_tpu_torch.initialize: model is required"
    if config is None:
        config = config_params
    if config is None and getattr(args, "deepspeed_config", None) is not None:
        config = args.deepspeed_config
    assert config is not None, "a config dict/path is required"
    ds_config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
    if type(model).__name__ == "PipelineModule":
        raise NotPortedError("the pipeline engine is not ported yet")
    if ds_config.hybrid_engine.enabled:
        raise NotPortedError("the hybrid engine is not ported yet")
    engine = DeepSpeedEngine(model, ds_config, optimizer=optimizer,
                             lr_scheduler=lr_scheduler,
                             training_data=training_data,
                             collate_fn=collate_fn, device=device,
                             params=params)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
