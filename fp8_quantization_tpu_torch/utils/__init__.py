"""Host-side utilities (port of ``fp8_quantization_tpu.utils``)."""
