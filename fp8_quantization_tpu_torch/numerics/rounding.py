"""Rounding primitives as ``torch.autograd.Function``s (port of
``numerics/rounding.py``, whose ``jax.custom_vjp``s they replace).

Forwards are bit-exact with the JAX package; backwards are the
straight-through estimators and, for QAT, the gradient-shaping ones: LSQ's
``scale_grad``, EWGS (``ewgs_round``) and the stacked-sigmoid rounding.
Powers of two are built from the float's exponent field, never from
``exp2``/``pow`` (the package-wide invariant).
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


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = lo, hi
        if isinstance(lo, torch.Tensor) != isinstance(hi, torch.Tensor):
            return torch.clamp(torch.clamp(x, min=lo), max=hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = (x > lo) & (x < hi)
        edge = (x == lo) | (x == hi)
        return g * inside + 0.5 * g * edge, None, None


def clip(x, lo, hi):
    """``jnp.clip`` (``minimum(maximum(x, lo), hi)``) with constant bounds
    (numbers, or tensors without a gradient): the values of
    ``torch.clamp``, and the JAX package's gradient, which is split in half
    at a bound, where ``torch.clamp`` passes all of it. Quantized values
    land on their grid's integer bounds exactly, and ReLU6 meets exact
    zeros, so QAT's gradients need it."""
    return _Clip.apply(x, lo, hi)


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


class _StochasticRoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, generator):
        noise = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        return torch.floor(x + noise)

    @staticmethod
    def backward(ctx, g):
        return g, None


def stochastic_round_ste(x, generator=None):
    """``floor(x + u)`` with ``u`` uniform in [0, 1) drawn from ``generator``
    (the JAX package takes a PRNG key); identity gradient."""
    return _StochasticRoundSTE.apply(x, generator)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x, scale):
    """Identity forward; the gradient is multiplied by ``scale`` (LSQ's
    gradient scaling of a quantizer's step and zero point)."""
    return _ScaleGrad.apply(x, scale)


class _EWGSRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scaling_factor):
        x_int = torch.round(x)
        ctx.save_for_backward(x - x_int)
        ctx.delta = scaling_factor
        return x_int

    @staticmethod
    def backward(ctx, g):
        (diff,) = ctx.saved_tensors
        return g * (1 + ctx.delta * torch.sign(g) * diff), None


def ewgs_round(x, scaling_factor):
    """Round half to even; the element-wise gradient scaling of EWGS:
    ``g * (1 + delta * sign(g) * (x - round(x)))``."""
    return _EWGSRound.apply(x, scaling_factor)


class _StackedSigmoidRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x)
        # a number stays on the host: a 0-dim tensor joins any device's ops
        ctx.alpha = torch.as_tensor(alpha, dtype=x.dtype)
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        alpha = ctx.alpha
        sig_scale = 1 - 2 * torch.sigmoid(alpha / 2)
        x_rest = x - torch.floor(x) - 0.5
        s = torch.sigmoid(x_rest * -alpha)
        return s * (1 - s) * -alpha / sig_scale * g, None


def stacked_sigmoid_round(x, alpha):
    """Round half to even; the gradient is that of a sigmoid of steepness
    ``alpha`` stacked on every integer step."""
    return _StackedSigmoidRound.apply(x, alpha)
