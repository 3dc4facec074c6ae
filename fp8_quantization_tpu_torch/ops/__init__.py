"""Quantized layers and the hand-written CUDA kernels they call (port of
``fp8_quantization_tpu.ops``; ``ops/cuda`` takes the place of
``ops/pallas``)."""
