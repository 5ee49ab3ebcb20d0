from deepspeed_tpu_torch.utils.logging import log_dist, logger  # noqa: F401
