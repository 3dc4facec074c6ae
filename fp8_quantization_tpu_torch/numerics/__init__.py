"""Numerics core: ExMy formats, codec, FP8 STE quantization, the plain
approximate matmul (port of ``fp8_quantization_tpu.numerics``)."""

from .approx_matmul import approx_matmul_golden, approx_products
from .codec import compose, decompose, quantize_exmy
from .formats import E2M5, E3M4, E4M3, E5M2, ExMy, default_bias
from .fp8_ste import default_maxval, quantize_to_fp8_ste
from .luts import get_error_table
from .rounding import exp2_exact, exp2_int, round_ste

__all__ = [
    "approx_matmul_golden",
    "approx_products",
    "compose",
    "decompose",
    "quantize_exmy",
    "ExMy",
    "E2M5",
    "E3M4",
    "E4M3",
    "E5M2",
    "default_bias",
    "default_maxval",
    "quantize_to_fp8_ste",
    "get_error_table",
    "exp2_exact",
    "exp2_int",
    "round_ste",
]
