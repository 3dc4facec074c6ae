"""FP (ExMy) quantizer as pure functions over a dict-of-tensors state (port
of ``quant/quantizers.py``; the uniform quantizers belong to a later slice).

``channel_axis`` selects the axis per-channel parameters broadcast along, so
``(in, out)`` dense and ``(*K, I, O)`` conv kernels quantize per output
channel with axis -1.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import LATER as _LATER
from ..config import FP8Config, QMethod, QuantizerConfig
from ..numerics.fp8_ste import default_maxval, quantize_to_fp8_ste
from ..numerics.rounding import round_ste

QuantState = Dict[str, torch.Tensor]


def _require_fp(cfg: QuantizerConfig):
    if cfg.method != QMethod.fp_quantizer:
        raise NotImplementedError(f"the {cfg.method.value} quantizer {_LATER}")


def bcast_param(p, ndim: int, channel_axis: int):
    """Reshape a per-channel (C,) parameter for broadcast along ``channel_axis``."""
    if p.ndim == 0 or p.shape[0] == 1 or ndim <= 1:
        return p
    shape = [1] * ndim
    shape[channel_axis % ndim] = -1
    return p.reshape(shape)


def fp_init(cfg: QuantizerConfig, num_channels: int = 1, device=None) -> QuantState:
    """Initial FP quantizer state."""
    _require_fp(cfg)
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


def init(cfg: QuantizerConfig, num_channels: int = 1, device=None) -> QuantState:
    return fp_init(cfg, num_channels, device)


def apply(cfg: QuantizerConfig, state: QuantState, x, channel_axis: int = 0):
    """Quantize-dequantize ``x``; returns just the tensor."""
    _require_fp(cfg)
    return fp_apply(cfg, state, x, channel_axis)[0]


def set_quant_range(cfg: QuantizerConfig, state: QuantState, x_min, x_max
                    ) -> QuantState:
    _require_fp(cfg)
    return fp_set_quant_range(cfg, state, x_min, x_max)
