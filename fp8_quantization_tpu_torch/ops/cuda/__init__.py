"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version. Sources live in ``fp8_quantization_tpu_torch/csrc``;
``build`` compiles them at first use."""
