"""Quantizers, range estimators and quantization sites (port of
``fp8_quantization_tpu.quant``)."""

from .sites import ESTIMATE, FIXED, FP32, QuantPhase, QuantSite

__all__ = ["ESTIMATE", "FIXED", "FP32", "QuantPhase", "QuantSite"]
