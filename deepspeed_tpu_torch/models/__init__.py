from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel  # noqa: F401
