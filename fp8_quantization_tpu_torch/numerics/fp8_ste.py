"""FP8/ExMy fake-quantization with STE rounding (port of
``numerics/fp8_ste.py``).

Math (identical to the JAX package):
  M          = clamp(round_ste(mantissa_bits), 1, n_bits - sign_bits)
  E          = n_bits - sign_bits - M
  bias       = round(2^E - log2(maxval) + log2(2 - 2^-M) - 1)
  xc         = clip(x, -maxval | 0, maxval)
  log_scales = max(floor(log2|xc|) + bias, 1), floor(log2|xc|) read from the
               IEEE exponent field
  scales     = 2^(log_scales - M - bias)
  result     = round_ste(xc / scales) * scales
"""

from __future__ import annotations

import torch

from .rounding import exp2_exact, round_ste


def quantize_to_fp8_ste(x_float, n_bits: int, maxval, mantissa_bits, sign_bits):
    """Fake-quantize ``x_float`` onto the FP8/ExMy grid defined by ``maxval``.

    ``maxval`` is ``(1,)`` per-tensor, ``(C,)`` per-channel along the leading
    axis of ``x_float``, or any shape broadcastable to it. Returns
    ``(result, bias)``: the quantized tensor and the derived exponent bias.
    """
    x_float = torch.as_tensor(x_float)
    dt, dev = x_float.dtype, x_float.device
    maxval = torch.as_tensor(maxval, dtype=dt, device=dev)
    mantissa_bits = torch.as_tensor(mantissa_bits, dtype=dt, device=dev)
    sign_b = torch.as_tensor(sign_bits, device=dev).to(dt)

    M = torch.minimum(torch.clamp(round_ste(mantissa_bits), min=1.0), n_bits - sign_b)
    E = n_bits - sign_b - M

    if maxval.ndim >= 1 and maxval.shape[0] != 1 and maxval.ndim != x_float.ndim:
        maxval = maxval.reshape((-1,) + (1,) * (x_float.ndim - 1))

    bias = torch.round(2.0 ** E - torch.log2(maxval) + torch.log2(2 - 2.0 ** (-M)) - 1)

    minval = torch.where(sign_b == 1, -maxval, torch.zeros_like(maxval))
    xc = torch.minimum(torch.maximum(x_float, minval), maxval)

    # floor(log2|xc| + bias) == ieee_exponent(xc) + bias for integral bias
    bits = xc.detach().contiguous().view(torch.int32)
    e_ieee = (torch.bitwise_right_shift(bits, 23) & 0xFF) - 127
    log_scales = torch.clamp(e_ieee.to(bias.dtype) + bias, min=1.0)

    scales = exp2_exact(log_scales - M - bias)
    result = round_ste(xc / scales) * scales
    return result, bias


def default_maxval(n_bits: int, mantissa_bits: int) -> float:
    """Default signed maxval ``(2 - 2^-M) * 2^(2^E - 1 - default_bias)``."""
    ebits = n_bits - mantissa_bits - 1
    default_bias = 2.0 ** (ebits - 1)
    return (2 - 2.0 ** -mantissa_bits) * 2.0 ** (2 ** ebits - 1 - default_bias)
