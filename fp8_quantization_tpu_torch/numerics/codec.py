"""ExMy codec: float <-> (expo, mant) integer fields (port of
``numerics/codec.py``, the part the v9 approximate matmul uses).

``bias`` may be a broadcastable tensor, so a per-output-channel weight bias is
one vectorized call. Bit-exact with the JAX package: ``frexp`` splits the
float, powers of two are exact (``rounding.ldexp``), and the mantissa is
rounded half-to-even and clamped at the top of its binade without carrying
into the exponent.
"""

from __future__ import annotations

import torch

from .rounding import ldexp, to_int32


def decompose(values, mant_width: int, bias, *, expo_width: int | None = None,
              clip_of: bool = False):
    """Split float values into (expo, mant) int32 fields of an ExMy format.

    Subnormals get ``expo == 0``; without ``clip_of`` the exponent extends
    beyond ``2^expo_width - 1`` to hold overflow. Returns int32 tensors shaped
    like ``values``.
    """
    values = torch.as_tensor(values).to(torch.float32)
    bias_i = to_int32(bias, values.device)
    max_mant = (1 << mant_width) - 1

    mant, expo = torch.frexp(values)   # values = mant * 2^expo, |mant| in [0.5, 1)

    min_norm = ldexp(torch.ones((), device=values.device), 1 - bias_i)
    subnorm = torch.abs(values) < min_norm

    sub_shift = expo + bias_i - 1 + mant_width
    mant_int = torch.where(
        subnorm,
        ldexp(torch.abs(mant), sub_shift),
        ldexp(torch.abs(mant) * 2.0 - 1.0, torch.full_like(expo, mant_width)),
    )
    mant_int = torch.clamp(torch.round(mant_int), max=max_mant).to(torch.int32)
    expo_int = torch.where(subnorm, 0, expo + (bias_i - 1)).to(torch.int32)

    if clip_of:
        if expo_width is None:
            raise ValueError("clip_of requires expo_width")
        max_expo = (1 << expo_width) - 1
        max_norm = ldexp(torch.full(bias_i.shape, 2.0 - 2.0 ** (-mant_width),
                                    device=values.device), max_expo - bias_i)
        overflow = (values < -max_norm) | (values > max_norm)
        expo_int = torch.where(overflow, max_expo, expo_int).to(torch.int32)
        mant_int = torch.where(overflow, max_mant, mant_int).to(torch.int32)
    return expo_int, mant_int


def compose(expo, mant, mant_width: int, bias, sign=None):
    """Rebuild float values from (expo, mant) fields. ``expo == 0`` decodes as
    subnormal ``2^(1-bias) * m/2^M``; otherwise ``2^(expo-bias) * (1 + m/2^M)``."""
    expo = to_int32(expo)
    mant = to_int32(mant, expo.device)
    bias_i = to_int32(bias, expo.device)
    frac = mant.to(torch.float32) / float(1 << mant_width)
    values = torch.where(
        expo == 0,
        ldexp(frac, torch.broadcast_to(1 - bias_i, frac.shape)),
        ldexp(1.0 + frac, expo - bias_i),
    )
    if sign is not None:
        values = values * torch.as_tensor(sign, dtype=torch.float32, device=values.device)
    return values


def quantize_exmy(arr, expo_width: int, mant_width: int, bias, *, clip_of: bool = True):
    """Round-trip quantize floats onto the ExMy grid (the codec rounding:
    no carry at binade tops)."""
    arr = torch.as_tensor(arr).to(torch.float32)
    expo, mant = decompose(arr, mant_width, bias, expo_width=expo_width, clip_of=clip_of)
    sign = torch.where(arr < 0, -1.0, 1.0)
    return compose(expo, mant, mant_width, bias, sign=sign)


def decompose_allnorm(values, mant_width: int, bias, *,
                      expo_width: int | None = None, clip_of: bool = False):
    """All-normal ExMy variant: no subnormals; zero iff expo == mant == 0.
    Magnitudes below ``2^-bias (1 + 2^-M)`` collapse to the zero code."""
    values = torch.as_tensor(values).to(torch.float32)
    bias_i = to_int32(bias, values.device)
    max_mant = (1 << mant_width) - 1

    mant, expo = torch.frexp(values)
    min_value = ldexp(torch.full(bias_i.shape, 1.0 + 2.0 ** (-mant_width),
                                 device=values.device), -bias_i)
    zero = (values > -min_value) & (values < min_value)

    mant_int = torch.where(
        zero, 0.0,
        ldexp(torch.abs(mant) * 2.0 - 1.0, torch.full_like(expo, mant_width)))
    mant_int = torch.clamp(torch.round(mant_int), max=max_mant).to(torch.int32)
    expo_int = torch.where(zero, 0, expo + (bias_i - 1)).to(torch.int32)

    if clip_of:
        if expo_width is None:
            raise ValueError("clip_of requires expo_width")
        max_expo = (1 << expo_width) - 1
        max_value = ldexp(torch.full(bias_i.shape, 2.0 - 2.0 ** (-mant_width),
                                     device=values.device), max_expo - bias_i)
        overflow = (values < -max_value) | (values > max_value)
        expo_int = torch.where(overflow, max_expo, expo_int).to(torch.int32)
        mant_int = torch.where(overflow, max_mant, mant_int).to(torch.int32)
    return expo_int, mant_int


def compose_allnorm(expo, mant, mant_width: int, bias, sign=None):
    """Inverse of :func:`decompose_allnorm`."""
    expo = to_int32(expo)
    mant = to_int32(mant, expo.device)
    bias_i = to_int32(bias, expo.device)
    frac = mant.to(torch.float32) / float(1 << mant_width)
    zero = (expo == 0) & (mant == 0)
    values = torch.where(zero, 0.0, ldexp(1.0 + frac, expo - bias_i))
    if sign is not None:
        values = values * torch.as_tensor(sign, dtype=torch.float32, device=values.device)
    return values


def quantize_exmy_allnorm(arr, expo_width: int, mant_width: int, bias, *,
                          clip_of: bool = True):
    """All-normal round-trip quantize: magnitudes below ``2^-bias (1 + 2^-M)``
    collapse to zero instead of denormalizing."""
    arr = torch.as_tensor(arr).to(torch.float32)
    expo, mant = decompose_allnorm(arr, mant_width, bias,
                                   expo_width=expo_width, clip_of=clip_of)
    sign = torch.where(arr < 0, -1.0, 1.0)
    return compose_allnorm(expo, mant, mant_width, bias, sign=sign)
