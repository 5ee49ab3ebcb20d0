from deepspeed_tpu_torch.accelerator.abstract_accelerator import (  # noqa: F401
    CARD_PEAKS, DeepSpeedAccelerator, DeviceUnavailableError, card_peaks)
from deepspeed_tpu_torch.accelerator.real_accelerator import (  # noqa: F401
    CPU_Accelerator, CUDA_Accelerator, get_accelerator)
