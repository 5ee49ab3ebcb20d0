from deepspeed_tpu_torch.compression.quantize import (  # noqa: F401
    dequantize_int8, quantize_int8)
