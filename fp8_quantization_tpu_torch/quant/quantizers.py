"""The FP (ExMy) and uniform quantizers as pure functions over a
dict-of-tensors state (port of ``quant/quantizers.py``).

* FP quantizer: state ``maxval``, ``mantissa_bits``, ``sign_bits``;
* symmetric and asymmetric uniform: state ``delta``, ``zero_float``,
  ``signed`` (the JAX state keys, so ``models.bridge`` carries them as they
  are). ``x / scale`` is one IEEE division and ``torch.round`` rounds half to
  even as ``jnp.round`` does, so the uniform functions equal the JAX
  package's bit for bit.

``channel_axis`` selects the axis per-channel parameters broadcast along, so
``(in, out)`` dense and ``(*K, I, O)`` conv kernels quantize per output
channel with axis -1.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import LATER as _LATER
from ..config import FP8Config, QMethod, QuantizerConfig
from ..numerics.fp8_ste import default_maxval, quantize_to_fp8_ste, quantize_to_fp8_ste_affine
from ..numerics.rounding import pow2, round_ste

QuantState = Dict[str, torch.Tensor]

_EPS = 1e-8  # the uniform quantizers' smallest scale and range


def bcast_param(p, ndim: int, channel_axis: int):
    """Reshape a per-channel (C,) parameter for broadcast along ``channel_axis``."""
    if p.ndim == 0 or p.shape[0] == 1 or ndim <= 1:
        return p
    shape = [1] * ndim
    shape[channel_axis % ndim] = -1
    return p.reshape(shape)


def fp_init(cfg: QuantizerConfig, num_channels: int = 1, device=None) -> QuantState:
    """Initial FP quantizer state."""
    fp8: FP8Config = cfg.fp8
    mv = float(fp8.maxval) if fp8.maxval is not None else default_maxval(
        cfg.n_bits, fp8.mantissa_bits)
    n = num_channels if cfg.per_channel else 1
    return {
        "maxval": torch.full((n,), mv, dtype=torch.float32, device=device),
        "mantissa_bits": torch.tensor([float(fp8.mantissa_bits)], device=device),
        "sign_bits": torch.tensor([1], dtype=torch.int32, device=device),
    }


def fp_apply(cfg: QuantizerConfig, state: QuantState, x, channel_axis: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-dequantize; returns (result, derived exponent bias)."""
    maxval = bcast_param(state["maxval"], x.ndim, channel_axis)
    return quantize_to_fp8_ste(x, cfg.n_bits, maxval, state["mantissa_bits"],
                               state["sign_bits"])


def fp_apply_affine(cfg: QuantizerConfig, state: QuantState, aff
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a pending :class:`~..quant.sites.Affine` value with its
    affine and clamp folded into the FP8 clip. Per-tensor sites only: the
    affine's constants ride the last axis, where a per-channel ``maxval``
    would fight them (such sites decode the input instead)."""
    assert not cfg.per_channel
    return quantize_to_fp8_ste_affine(aff.x, aff.scale, aff.bias, aff.lo, aff.hi, cfg.n_bits,
                                      state["maxval"], state["mantissa_bits"],
                                      state["sign_bits"])


def fp_bias(cfg: QuantizerConfig, state: QuantState) -> torch.Tensor:
    """Derived exponent bias without quantizing data."""
    sign_b = state["sign_bits"].to(torch.float32)
    M = torch.minimum(torch.clamp(round_ste(state["mantissa_bits"]), min=1.0),
                      cfg.n_bits - sign_b)
    E = cfg.n_bits - sign_b - M
    bias = 2.0 ** E - torch.log2(state["maxval"]) + torch.log2(2 - 2.0 ** (-M)) - 1
    return torch.round(bias)


def fp_set_quant_range(cfg: QuantizerConfig, state: QuantState, x_min, x_max
                       ) -> QuantState:
    """Fold (min, max) into maxval when ``set_maxval``; flip to unsigned when
    allowed and the range is non-negative."""
    x_min = torch.atleast_1d(x_min.to(torch.float32))
    x_max = torch.atleast_1d(x_max.to(torch.float32))
    new = dict(state)
    if cfg.fp8.allow_unsigned:
        unsigned = torch.all(x_min >= 0)
        new["sign_bits"] = torch.where(unsigned, 0, 1).reshape(1).to(torch.int32)
    if cfg.fp8.set_maxval:
        mx = torch.abs(torch.maximum(torch.abs(x_min), x_max))
        new["maxval"] = mx.reshape(state["maxval"].shape)
    return new


def uniform_init(cfg: QuantizerConfig, num_channels: int = 1, device=None) -> QuantState:
    """Initial uniform quantizer state (``signed`` is read by the symmetric
    quantizer only)."""
    n = num_channels if cfg.per_channel else 1
    return {
        "delta": torch.ones((n,), dtype=torch.float32, device=device),
        "zero_float": torch.zeros((n,), dtype=torch.float32, device=device),
        "signed": torch.tensor([1], dtype=torch.int32, device=device),
    }


def uniform_scale(cfg: QuantizerConfig, delta):
    """The grid step: ``delta`` (at least ``_EPS``) in the linear scale
    domain, ``exp(delta)`` in the log domain."""
    if cfg.scale_domain == "linear":
        return torch.clamp(delta, min=_EPS)
    return torch.exp(delta)


def sym_int_bounds(cfg: QuantizerConfig, signed):
    """(int_min, int_max) of a symmetric grid: ``[-2^(b-1), 2^(b-1) - 1]``
    when signed, ``[0, 2^b - 1]`` when not."""
    signed_f = signed.to(torch.float32)
    int_min = -(2.0 ** (cfg.n_bits - 1)) * signed_f
    int_max = pow2(cfg.n_bits - signed.to(torch.int32)) - 1
    return int_min, int_max


def uniform_apply(cfg: QuantizerConfig, state: QuantState, x, channel_axis: int = 0,
                  grad_scaling: bool = False):
    """Fake-quantize ``x`` onto the uniform grid:
    ``scale * (clip(round(x / scale) + zp, int_min, int_max) - zp)`` with the
    straight-through rounding gradient."""
    if grad_scaling:
        raise NotImplementedError(f"LSQ gradient scaling {_LATER}")
    delta = bcast_param(state["delta"], x.ndim, channel_axis)
    scale = uniform_scale(cfg, delta)
    if cfg.method == QMethod.symmetric_uniform:
        int_min, int_max = sym_int_bounds(cfg, state["signed"])
        zero_point = 0.0
    else:
        int_min, int_max = 0.0, 2.0 ** cfg.n_bits - 1
        zp = round_ste(bcast_param(state["zero_float"], x.ndim, channel_axis))
        zero_point = torch.clamp(zp, int_min, int_max)
    x_int = torch.clamp(round_ste(x / scale) + zero_point, int_min, int_max)
    return scale * (x_int - zero_point)


def uniform_set_quant_range(cfg: QuantizerConfig, state: QuantState, x_min, x_max
                            ) -> QuantState:
    """Fold (min, max) into the grid: the range always holds zero and is at
    least ``_EPS`` wide; a symmetric grid is unsigned when the whole range
    is non-negative, an asymmetric one takes its zero point from ``x_min``."""
    x_min = torch.clamp(torch.atleast_1d(x_min.to(torch.float32)), max=0.0)
    x_max = torch.clamp(torch.atleast_1d(x_max.to(torch.float32)), min=_EPS)
    new = dict(state)
    if cfg.method == QMethod.symmetric_uniform:
        signed = (torch.min(x_min) < 0).to(torch.int32).reshape(1)
        _, int_max = sym_int_bounds(cfg, signed)
        delta = torch.maximum(torch.abs(x_min), x_max) / int_max
        new["signed"] = signed
    else:
        delta = (x_max - x_min) / (2.0 ** cfg.n_bits - 1)
        new["zero_float"] = (-x_min / delta).reshape(state["zero_float"].shape)
    if cfg.scale_domain == "log":
        delta = torch.log(delta)
    new["delta"] = delta.reshape(state["delta"].shape)
    return new


def init(cfg: QuantizerConfig, num_channels: int = 1, device=None) -> QuantState:
    if cfg.method == QMethod.fp_quantizer:
        return fp_init(cfg, num_channels, device)
    return uniform_init(cfg, num_channels, device)


def apply(cfg: QuantizerConfig, state: QuantState, x, channel_axis: int = 0,
          grad_scaling: bool = False):
    """Quantize-dequantize ``x``; returns just the tensor."""
    if cfg.method == QMethod.fp_quantizer:
        return fp_apply(cfg, state, x, channel_axis)[0]
    return uniform_apply(cfg, state, x, channel_axis, grad_scaling)


def set_quant_range(cfg: QuantizerConfig, state: QuantState, x_min, x_max
                    ) -> QuantState:
    if cfg.method == QMethod.fp_quantizer:
        return fp_set_quant_range(cfg, state, x_min, x_max)
    return uniform_set_quant_range(cfg, state, x_min, x_max)
