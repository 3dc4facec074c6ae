"""ExMy codec: float <-> (expo, mant) integer fields and 1-byte codes (port
of ``numerics/codec.py``: the v9 approximate matmul's part and the byte
packing of the packed-FP8 serving path).

``bias`` may be a broadcastable tensor, so a per-output-channel weight bias is
one vectorized call. Bit-exact with the JAX package: ``frexp`` splits the
float, powers of two are exact (``rounding.ldexp`` or a write into the f32
exponent field), the mantissa is rounded half-to-even and clamped at the top
of its binade without carrying into the exponent, and integer arithmetic on
biases wraps in int32 as XLA's does.
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


def code_of(expo, mant, mant_width: int):
    """Pack fields into the flat integer code ``expo << M | mant``."""
    return to_int32(expo) * (1 << mant_width) + to_int32(mant)


def fields_of(code, mant_width: int):
    """Unpack the flat integer code into (expo, mant)."""
    code = to_int32(code)
    return (torch.div(code, 1 << mant_width, rounding_mode="floor"),
            torch.remainder(code, 1 << mant_width))


def f32_bits(bits):
    """Reinterpret int32 bits as float32."""
    return bits.to(torch.int32).contiguous().view(torch.float32)


def pack_exmy(values, expo_width: int, mant_width: int, bias, *,
              signed: bool = True, clip_of: bool = False):
    """Pack grid values into flat byte codes ``s:1 | e:expo_width | m:mant_width``.

    ``values`` must already sit on the ExMy grid; with ``clip_of`` they are
    first clamped onto the format's range (out-of-range magnitudes take the
    largest finite code). -0.0 packs as +0.0. Returns uint8 when the code
    fits in 8 bits, else int32.
    """
    total = int(signed) + expo_width + mant_width
    if total > 32:
        raise ValueError(f"an E{expo_width}M{mant_width} code does not fit 32 bits")
    values = torch.as_tensor(values).to(torch.float32)
    expo, mant = decompose(values, mant_width, bias, expo_width=expo_width,
                           clip_of=clip_of)
    expo = torch.clamp(expo, 0, (1 << expo_width) - 1)
    code = torch.bitwise_left_shift(expo, mant_width) | mant
    if signed:
        neg = torch.signbit(values) & (code > 0)
        code = code | torch.bitwise_left_shift(neg.to(torch.int32),
                                               expo_width + mant_width)
    return code.to(torch.uint8 if total <= 8 else torch.int32)


def unpack_exmy(codes, expo_width: int, mant_width: int, bias, *,
                signed: bool = True, dtype=torch.float32):
    """Decode flat byte codes back to float, the inverse of :func:`pack_exmy`:

      value = (implicit_one + m * 2^-M) * 2^(max(e, 1) - bias)

    with ``2^k`` written into an f32 exponent field and ``implicit_one`` 0
    for the subnormal binade ``e == 0``.
    """
    c = to_int32(codes)
    bias_i = to_int32(bias, c.device)
    em = c & ((1 << (expo_width + mant_width)) - 1)
    e = torch.bitwise_right_shift(em, mant_width)
    m = em & ((1 << mant_width) - 1)
    ee = torch.clamp(e, min=1)
    pow2 = f32_bits(torch.bitwise_left_shift(ee - bias_i + 127, 23))
    lead = torch.where(e > 0, 1.0, 0.0)
    val = (lead + m.to(torch.float32) * (2.0 ** -mant_width)) * pow2
    if signed:
        s = torch.bitwise_right_shift(c, expo_width + mant_width)
        val = torch.where(s > 0, -val, val)
    return val.to(dtype)


def unpack_exmy_bits(codes, expo_width: int, mant_width: int, ebase_bits,
                     sub_scale, dtype=torch.float32):
    """Decode by assembling the f32 bit pattern directly (bit-exact with
    :func:`unpack_exmy`; the kernels' decode). A normal code's ``e:E|m:M``
    field pair shifted left by ``23 - M`` lands on the f32 exponent and
    mantissa fields, so ``bits = (em << (23 - M)) + ((127 - bias) << 23)``;
    a subnormal code decodes as ``m * 2^(1 - bias - M)``. The per-channel
    constants come from :func:`unpack_consts`.
    """
    c = to_int32(codes)
    em = c & ((1 << (expo_width + mant_width)) - 1)
    fnorm = f32_bits(torch.bitwise_left_shift(em, 23 - mant_width)
                      + to_int32(ebase_bits, c.device))
    fsub = em.to(torch.float32) * torch.as_tensor(sub_scale, dtype=torch.float32,
                                                  device=c.device)
    val = torch.where(em >= (1 << mant_width), fnorm, fsub)
    s = torch.bitwise_right_shift(c, expo_width + mant_width)
    val = torch.where(s > 0, -val, val)
    return val.to(dtype)


def unpack_consts(bias, mant_width: int):
    """``(ebase_bits, sub_scale)`` for :func:`unpack_exmy_bits`:
    ``(127 - bias) << 23`` (int32) and ``2^(1 - bias - mant_width)``
    (float32), per channel or per tensor like ``bias``."""
    bias_i = to_int32(bias)
    ebase_bits = torch.bitwise_left_shift(127 - bias_i, 23)
    sub_scale = f32_bits(torch.bitwise_left_shift(127 + 1 - bias_i - mant_width, 23))
    return ebase_bits, sub_scale


def value_space(expo_width: int, mant_width: int, bias):
    """All ``2^(E+M)`` non-negative code values of the format."""
    codes = torch.arange(1 << (expo_width + mant_width), dtype=torch.int32)
    expo, mant = fields_of(codes, mant_width)
    return compose(expo, mant, mant_width, bias)
