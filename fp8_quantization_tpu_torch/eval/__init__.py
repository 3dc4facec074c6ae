"""Eval driver, metrics and data (port of ``fp8_quantization_tpu.eval``)."""
