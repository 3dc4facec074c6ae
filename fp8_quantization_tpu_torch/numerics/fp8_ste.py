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

import numpy as np
import torch

from .rounding import clip, exp2_exact, round_ste


def _mant_and_bias(n_bits: int, maxval, mantissa_bits, sign_b):
    """(M, bias) of the grid: the mantissa width clamped to the format and
    the derived exponent bias."""
    M = clip(round_ste(mantissa_bits), 1.0, n_bits - sign_b)
    E = n_bits - sign_b - M
    return M, torch.round(2.0 ** E - torch.log2(maxval) + torch.log2(2 - 2.0 ** (-M)) - 1)


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

    if maxval.ndim >= 1 and maxval.shape[0] != 1 and maxval.ndim != x_float.ndim:
        maxval = maxval.reshape((-1,) + (1,) * (x_float.ndim - 1))
    M, bias = _mant_and_bias(n_bits, maxval, mantissa_bits, sign_b)

    minval = torch.where(sign_b == 1, -maxval, torch.zeros_like(maxval))
    xc = torch.minimum(torch.maximum(x_float, minval), maxval)

    # floor(log2|xc| + bias) == ieee_exponent(xc) + bias for integral bias
    bits = xc.detach().contiguous().view(torch.int32)
    e_ieee = (torch.bitwise_right_shift(bits, 23) & 0xFF) - 127
    log_scales = torch.clamp(e_ieee.to(bias.dtype) + bias, min=1.0)

    scales = exp2_exact(log_scales - M - bias)
    result = round_ste(xc / scales) * scales
    return result, bias


def quantize_to_fp8_ste_affine(x_raw, a_scale, a_bias, lo, hi, n_bits: int, maxval,
                               mantissa_bits, sign_bits):
    """A pending per-channel affine and clamp folded into the FP8
    fake-quantize: equal to ``quantize_to_fp8_ste(clip(x_raw * a_scale +
    a_bias, lo, hi), ...)`` with the clamp merged into the quantizer's own
    ``[minval, maxval]`` clip, which is exact wherever the two intervals
    overlap (every clamp of ``ops.activations.CLAMP_ACTIVATIONS``).
    ``a_scale`` / ``a_bias`` broadcast on the last axis; ``maxval`` is the
    per-tensor ``(1,)`` state. ``x_raw * a_scale`` and ``+ a_bias`` round
    apart in f32."""
    x_raw = torch.as_tensor(x_raw).to(torch.float32)
    dev = x_raw.device
    maxval = torch.as_tensor(maxval, dtype=torch.float32, device=dev)
    mantissa_bits = torch.as_tensor(mantissa_bits, dtype=torch.float32, device=dev)
    sign_b = torch.as_tensor(sign_bits, device=dev).to(torch.float32)

    M, bias = _mant_and_bias(n_bits, maxval, mantissa_bits, sign_b)

    minval = torch.where(sign_b == 1, -maxval, torch.zeros_like(maxval))
    lo_eff = minval if lo is None else torch.clamp(minval, min=lo)
    hi_eff = maxval if hi is None else torch.clamp(maxval, max=hi)

    v = x_raw * a_scale.to(torch.float32) + a_bias.to(torch.float32)
    xc = torch.minimum(torch.maximum(v, lo_eff), hi_eff)

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


def quantize_to_fp8_widths(x, n_bits: int, maxval, mbit_list, sign_bits):
    """Yields ``quantize_to_fp8_ste(x, n_bits, maxval, m, sign_bits)[0]``
    (no gradient) for each width ``m`` of ``mbit_list``, bit for bit, in
    fewer passes over the broadcast tensor: the MSE range search quantizes
    every element once a candidate ``maxval`` and a width, and on ViT-B/16
    this path takes half the plain version's time on an H100 (PERF.md §6).

    ``x`` (1, C, N) and ``maxval`` (K, C, 1) broadcast to each (K, C, N)
    result. The values are clipped, and their exponent fields read, once for
    all widths. With ``b`` the bias and ``e`` an element's IEEE exponent,
    the step is ``2^(max(e, 1 - b) - M)``: the same integer as the plain
    version's ``max(e + b, 1) - M - b``, written into an f32 exponent field
    (``max`` on the exponent field ignores the sign bit and the mantissa).
    A width whose step could leave the normal floats, or whose bias is not
    finite, takes :func:`quantize_to_fp8_ste` itself."""
    dev = x.device
    maxval = torch.as_tensor(maxval, dtype=torch.float32, device=dev)
    sign_b = torch.as_tensor(sign_bits, device=dev).to(torch.float32)
    xc = field = None
    for mbits in mbit_list:
        M, bias = _mant_and_bias(n_bits, maxval, torch.tensor(float(mbits), device=dev),
                                 sign_b)
        floor_e = 1 - bias                   # the subnormal binade's exponent
        if not bool((torch.isfinite(bias) & (floor_e - M >= -126) & (floor_e <= 127)).all()):
            with torch.no_grad():
                yield quantize_to_fp8_ste(x, n_bits, maxval, float(mbits), sign_b)[0]
            continue
        if xc is None:
            minval = torch.where(sign_b == 1, -maxval, torch.zeros_like(maxval))
            xc = torch.clamp(x, minval, maxval)
            field = torch.bitwise_and(xc.view(torch.int32), 0x7F800000)
        floor_field = torch.bitwise_left_shift((floor_e + 127).to(torch.int32), 23)
        m_field = torch.bitwise_left_shift(M.to(torch.int32), 23)
        step = torch.maximum(field, floor_field).sub_(m_field).view(torch.float32)
        yield torch.div(xc, step).round_().mul_(step)


def fp8_grid(num_total_bits: int = 8, num_exponent_bits: int = 4, bias: int = 8) -> np.ndarray:
    """Every representable value of the format, sorted ascending (host-side:
    the idempotency tests and the analytic error model use it)."""
    num_fraction_bits = num_total_bits - 1 - num_exponent_bits
    all_values = []
    for s in (-1.0, 1.0):
        for e_enc in range(2 ** num_exponent_bits):
            is_subnormal = 1 if (e_enc - bias) == -bias else 0
            for f_enc in range(2 ** num_fraction_bits):
                frac = f_enc * 2.0 ** -num_fraction_bits + 1 - is_subnormal
                all_values.append(s * 2.0 ** (e_enc - bias + is_subnormal) * frac)
    return np.sort(np.array(all_values))


def fp8_grid_scaled(num_total_bits: int, num_exp_bits: int, exp_bias: int,
                    range_limit_fp: float) -> np.ndarray:
    """:func:`fp8_grid` rescaled so its largest magnitude is ``range_limit_fp``."""
    grid = fp8_grid(num_total_bits, num_exp_bits, exp_bias)
    float_scale = np.max(np.abs(grid)) / range_limit_fp
    return grid / float_scale


def fp8_max_value(num_exponent_bits: int = 4, bias: int = 8) -> float:
    """Largest representable magnitude of an 8-bit format."""
    num_fraction_bits = 7 - num_exponent_bits
    max_frac = 1 - 2.0 ** -num_fraction_bits
    return 2.0 ** (2 ** num_exponent_bits - 1 - bias) * (1 + max_frac)
