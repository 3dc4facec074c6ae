"""Quantized models (port of ``fp8_quantization_tpu.models``) and the bridge
that carries JAX variables into them."""
