"""Rounding primitives as ``torch.autograd.Function``s (port of
``numerics/rounding.py``, whose ``jax.custom_vjp``s they replace).

Forwards are bit-exact with the JAX package; backwards are the
straight-through estimators. Powers of two are built from the float's
exponent field, never from ``exp2``/``pow`` (the package-wide invariant).
"""

from __future__ import annotations

import torch


def to_int32(x, device=None):
    """``x`` as int32, converted as XLA converts: NaN to 0 and out-of-range
    values (the ``+inf`` bias of a site that saw only zeros) saturated.
    PyTorch's own cast leaves those to the platform."""
    x = torch.as_tensor(x, device=device)
    if x.is_floating_point():
        x = torch.nan_to_num(x.to(torch.float64), nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    return x.to(torch.int32)


def pow2(e):
    """``2**e`` for an int tensor ``e``, exact for e in [-126, 127] and clamped
    to that range beyond it: writes ``e + 127`` into an f32 exponent field."""
    e = torch.as_tensor(e).to(torch.int32)
    return torch.bitwise_left_shift((e + 127).clamp(1, 254), 23).view(torch.float32)


def ldexp(x, e):
    """``x * 2**e`` for int ``e`` in [-252, 254], exact wherever the result is
    a normal float: two exact power-of-two factors (``torch.ldexp`` goes
    through ``pow``)."""
    e = torch.as_tensor(e).to(torch.int32)
    h = torch.div(e, 2, rounding_mode="floor")
    return x * pow2(h) * pow2(e - h)


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x):
    """Round to nearest (half-to-even); identity gradient."""
    return _RoundSTE.apply(x)


class _Exp2Exact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, arg):
        # a plain cast, not to_int32, on this hot path: only a site with
        # maxval 0 or inf gives a non-finite arg, and there the quantized
        # value comes out the same as under XLA's saturating cast
        out = pow2(torch.round(arg)).to(arg.dtype)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * out * 0.6931471805599453


def exp2_exact(arg):
    """``2**arg`` exactly for integral ``arg`` in [-126, 127]; backward is the
    smooth ``ln2 * 2^arg`` so learnable maxval/mantissa bits still train."""
    return _Exp2Exact.apply(torch.as_tensor(arg))


def exp2_int(e):
    """``2**e`` for an int tensor ``e``, exact, as float32."""
    e = torch.as_tensor(e)
    return ldexp(torch.ones(e.shape, dtype=torch.float32, device=e.device), e)
