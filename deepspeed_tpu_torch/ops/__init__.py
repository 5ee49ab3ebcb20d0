"""Ops of the PyTorch port. Each module that holds a hand-written CUDA kernel
(decode_step, int8_matmul) keeps its plain PyTorch version beside it and a
launch counter on its wrapper (``fused_decode_step.launches``,
``int8_matmul_dma.launches``)."""
