"""Quantizers, range estimators, quantization sites and QAT (port of
``fp8_quantization_tpu.quant``)."""

from . import qat

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
           "QuantPhase", "QuantSite", "decoded", "qat"]
