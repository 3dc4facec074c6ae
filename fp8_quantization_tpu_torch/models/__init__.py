"""Quantized models (port of ``fp8_quantization_tpu.models``), the bridge
that carries JAX variables into them, and the interceptor that quantizes any
foreign ``nn.Module``."""

from .flax_surgery import QuantizedFlaxModel, quantize_flax_model

__all__ = ["QuantizedFlaxModel", "quantize_flax_model"]
