"""PyTorch/CUDA port of ``fp8_quantization_tpu`` for an NVIDIA H100.

The JAX package beside this one is the reference; every module here keeps
its counterpart's subpackage and module name. This package imports torch,
numpy and the standard library only, and builds its CUDA kernels lazily at
first use (``ops/cuda``), so importing it needs no GPU and no compiler.
"""

# the end of every NotImplementedError raised for what this slice has not ported
LATER = "is not ported yet: it belongs to a later slice of the port"
