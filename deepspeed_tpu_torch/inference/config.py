"""Inference configuration of the PyTorch port: a dataclass taking the keys
of deepspeed_tpu's ``DeepSpeedInferenceConfig`` that the serving path and
``generate`` read (``dtype``, ``seed``, ``quant`` with
``quantize_embedding``, ``max_tokens`` / ``max_out_tokens``,
``min_out_tokens`` / ``min_tokens``, ``tensor_parallel.tp_size`` / ``tp``
— only 1 for now — and ``checkpoint``, an engine checkpoint directory or a
dict with ``checkpoint_dir`` / ``base_dir`` to serve its newest valid
tag)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

_DTYPES = {
    "fp32": torch.float32, "float32": torch.float32, "float": torch.float32,
    "fp16": torch.float16, "float16": torch.float16, "half": torch.float16,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}

_ALIASES = {"tp": "tensor_parallel", "max_out_tokens": "max_tokens",
            "min_tokens": "min_out_tokens"}


@dataclasses.dataclass
class TPConfig:
    enabled: bool = True
    tp_size: int = 1


@dataclasses.dataclass
class QuantizationConfig:
    enabled: bool = False
    bits: int = 8
    group_size: int = 64
    # also quantize a tied embedding / LM head (one int8 scale per vocab
    # row, serving both the gather and the logits)
    quantize_embedding: bool = False


@dataclasses.dataclass
class DeepSpeedInferenceConfig:
    dtype: Any = "bf16"
    tensor_parallel: Union[TPConfig, Dict] = dataclasses.field(
        default_factory=TPConfig)
    quant: Union[QuantizationConfig, Dict] = dataclasses.field(
        default_factory=QuantizationConfig)
    checkpoint: Optional[Union[str, Dict]] = None
    max_tokens: int = 1024
    min_out_tokens: int = 1
    seed: int = 0

    def __post_init__(self):
        if isinstance(self.tensor_parallel, dict):
            self.tensor_parallel = TPConfig(**self.tensor_parallel)
        if isinstance(self.quant, dict):
            self.quant = QuantizationConfig(**self.quant)
        if self.tensor_parallel.tp_size != 1:
            raise ValueError("the PyTorch port serves with tp_size=1 only "
                             f"(got {self.tensor_parallel.tp_size})")
        self.torch_dtype()   # fail on an unknown dtype at construction

    @classmethod
    def from_dict(cls, cfg: Dict) -> "DeepSpeedInferenceConfig":
        """Build from the JAX config's key names, aliases included."""
        return cls(**{_ALIASES.get(k, k): v for k, v in cfg.items()})

    def torch_dtype(self):
        d = self.dtype
        if isinstance(d, torch.dtype):
            return d
        key = str(d).lower().replace("torch.", "")
        if key not in _DTYPES:
            raise ValueError(f"unknown inference dtype {d!r}; one of "
                             f"{sorted(_DTYPES)}")
        return _DTYPES[key]

    @property
    def tp_size(self) -> int:
        return self.tensor_parallel.tp_size
