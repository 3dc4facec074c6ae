"""Quantizers, range estimators and quantization sites (port of
``fp8_quantization_tpu.quant``)."""

from .sites import (
    CHAINED,
    ESTIMATE,
    FAST,
    FIXED,
    FP32,
    PACKED,
    CodedFP,
    QuantPhase,
    QuantSite,
    decoded,
)

__all__ = ["CHAINED", "ESTIMATE", "FAST", "FIXED", "FP32", "PACKED", "CodedFP",
           "QuantPhase", "QuantSite", "decoded"]
