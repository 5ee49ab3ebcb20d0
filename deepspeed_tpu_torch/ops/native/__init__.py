from deepspeed_tpu_torch.ops.native.builder import NativeOpBuilder, build_native_lib  # noqa: F401
