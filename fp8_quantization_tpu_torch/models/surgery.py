"""Spec-based model surgery: quantized models built from layer specs (port
of ``models/surgery.py``).

A sequential model is a tuple of layer specs, and ``plan_sequential`` folds
its windows as the reference's ``quantize_sequential`` does: conv+BN(+act)
becomes one ``BNQuantConv``, linear+BN(+act) one ``BNQuantDense``,
conv/transposed conv/linear(+act) quantized layers with the activation
fused, and the parameter-free average pool gets an activation site (tied to
the layer before it, whose output site it takes over, when the input is not
quantized). ``QuantizedSequential`` builds the plan as an ``nn.Module``.

PyTorch modules need their input widths up front, where flax takes them
from the first input: ``QuantizedSequential`` takes the input's shape
without the batch dim and carries it through the plan. The submodules are
named as the flax module's auto-names (``layers_{i}`` by plan index, the
pool sites ``layers_{i}_activation_quantizer``), so ``models.bridge`` maps
a JAX variables tree onto this module's ``state_dict``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple, Union

import torch.nn.functional as F
from torch import nn

from ..config import QuantConfig
from ..ops.activations import ACTIVATIONS
from ..ops.layers import (BNQuantConv, BNQuantDense, QuantConv, QuantConvTranspose, QuantDense,
                          QuantLayerNorm, _explicit_padding)
from ..quant.sites import FIXED, QuantPhase, QuantSite, decoded

# --- layer specs (the FP32 model definition) ---


@dataclasses.dataclass(frozen=True)
class Conv:
    features: int
    kernel_size: Tuple[int, ...] = (3, 3)
    strides: Tuple[int, ...] = (1, 1)
    padding: Union[str, Tuple[Tuple[int, int], ...]] = "SAME"
    groups: int = 1
    use_bias: bool = True


@dataclasses.dataclass(frozen=True)
class ConvTranspose:
    features: int
    kernel_size: Tuple[int, ...] = (3, 3)
    strides: Tuple[int, ...] = (1, 1)
    padding: Union[str, Tuple[Tuple[int, int], ...]] = "SAME"
    use_bias: bool = True


@dataclasses.dataclass(frozen=True)
class Linear:
    features: int
    use_bias: bool = True


@dataclasses.dataclass(frozen=True)
class BatchNorm:
    epsilon: float = 1e-5


@dataclasses.dataclass(frozen=True)
class Act:
    name: str  # a key of ops.activations.ACTIVATIONS


@dataclasses.dataclass(frozen=True)
class LayerNorm:
    epsilon: float = 1e-6


@dataclasses.dataclass(frozen=True)
class AvgPool:
    window: Tuple[int, ...]
    strides: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class MaxPool:
    window: Tuple[int, ...]
    strides: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class Flatten:
    pass


Spec = Any

_QUANT_KINDS = ("conv", "bnconv", "convtranspose", "linear", "bnlinear")


def plan_sequential(specs: Sequence[Spec]):
    """Fold spec windows into build instructions, ``(kind, spec, act_name,
    bn_spec)`` tuples: conv->bn(->act) and linear->bn(->act) fold into one
    BN layer, conv/transposed conv/linear(->act) into one layer with the
    activation fused; LayerNorm stays a layer of its own, and pools,
    Flatten and a lone Act are ``plain``."""
    plan = []
    i, n = 0, len(specs)
    while i < n:
        s = specs[i]
        if isinstance(s, (Conv, ConvTranspose, Linear)):
            j = i + 1
            bn = None
            if j < n and isinstance(specs[j], BatchNorm):
                if isinstance(s, ConvTranspose):
                    raise TypeError("BatchNorm folding after ConvTranspose is not supported")
                bn = specs[j]
                j += 1
            act = None
            if j < n and isinstance(specs[j], Act):
                act = specs[j].name
                j += 1
            if bn is not None:
                kind = "bnconv" if isinstance(s, Conv) else "bnlinear"
            elif isinstance(s, Conv):
                kind = "conv"
            elif isinstance(s, ConvTranspose):
                kind = "convtranspose"
            else:
                kind = "linear"
            plan.append((kind, s, act, bn))
            i = j
        elif isinstance(s, LayerNorm):
            plan.append(("layernorm", s, None, None))
            i += 1
        elif isinstance(s, (AvgPool, MaxPool, Flatten, Act)):
            plan.append(("plain", s, None, None))
            i += 1
        else:
            raise TypeError(f"unsupported spec {s!r}")
    return plan


def _pool_out(spatial, window, strides):
    # flax's pools pad VALID
    return tuple((n - w) // s + 1 for n, w, s in zip(spatial, window, strides))


def _pool(x, s, avg: bool):
    """flax's ``avg_pool`` / ``max_pool`` (VALID) on a channels-last batch."""
    window = tuple(s.window)
    strides = tuple(s.strides or s.window)
    fn = {(1, True): F.avg_pool1d, (2, True): F.avg_pool2d,
          (1, False): F.max_pool1d, (2, False): F.max_pool2d}[(len(window), avg)]
    return fn(x.movedim(-1, 1), window, stride=strides).movedim(1, -1)


class QuantizedSequential(nn.Module):
    """A sequential quantized model built from specs (the surgery product).
    ``input_shape`` is one example's shape, channels last (``(W, C)``,
    ``(H, W, C)``, or ``(F,)`` for a dense model)."""

    def __init__(self, qc: QuantConfig, specs: Sequence[Spec], input_shape: Sequence[int], *,
                 tie_activation_quantizers: bool = True, generator=None, device=None):
        super().__init__()
        self.qc = qc
        self.plan = plan_sequential(specs)
        self.pool_sites = {}
        shape = tuple(input_shape)
        prev_quant_layer = None  # index of the last quantized layer (the tie source)
        kw = dict(generator=generator, device=device)
        for idx, (kind, s, act_name, bn) in enumerate(self.plan):
            act = ACTIVATIONS[act_name] if act_name else None
            nxt = self.plan[idx + 1] if idx + 1 < len(self.plan) else None
            # the act site moves to the pool when an average pool follows
            common = dict(activation=act, quantize_output=not (
                tie_activation_quantizers and nxt is not None
                and isinstance(nxt[1], AvgPool) and kind in _QUANT_KINDS))
            name = f"layers_{idx}"
            if kind in ("conv", "bnconv"):
                cls = BNQuantConv if kind == "bnconv" else QuantConv
                extra = dict(bn_epsilon=bn.epsilon) if kind == "bnconv" else {}
                layer = cls(qc, shape[-1], s.features, kernel_size=s.kernel_size,
                            strides=s.strides, padding=s.padding,
                            feature_group_count=s.groups,
                            use_bias=(False if kind == "bnconv" else s.use_bias),
                            **common, **extra, **kw)
                shape = self._conv_out(layer, shape)
                prev_quant_layer = idx
            elif kind == "convtranspose":
                layer = QuantConvTranspose(qc, shape[-1], s.features, kernel_size=s.kernel_size,
                                           strides=s.strides, padding=s.padding,
                                           use_bias=s.use_bias, **common, **kw)
                shape = self._conv_out(layer, shape)
                prev_quant_layer = idx
            elif kind in ("linear", "bnlinear"):
                cls = BNQuantDense if kind == "bnlinear" else QuantDense
                extra = dict(bn_epsilon=bn.epsilon) if kind == "bnlinear" else {}
                layer = cls(qc, shape[-1], s.features,
                            use_bias=(False if kind == "bnlinear" else s.use_bias),
                            **common, **extra, **kw)
                shape = (*shape[:-1], s.features)
                prev_quant_layer = idx
            elif kind == "layernorm":
                layer = QuantLayerNorm(qc, shape[-1], epsilon=s.epsilon, device=device)
                prev_quant_layer = idx
            else:
                layer = None
                if isinstance(s, AvgPool):
                    tie = (tie_activation_quantizers and prev_quant_layer is not None
                           and not qc.quantize_input)
                    site = f"layers_{prev_quant_layer if tie else idx}_activation_quantizer"
                    self.pool_sites[idx] = (site, tie)
                    self.add_module(site, QuantSite(qc.act_quantizer(), qc.act_range,
                                                    device=device))
                if isinstance(s, (AvgPool, MaxPool)):
                    shape = (*_pool_out(shape[:-1], s.window, s.strides or s.window), shape[-1])
                elif isinstance(s, Flatten):
                    shape = (math.prod(shape),)
            if layer is not None:
                self.add_module(name, layer)
        self.output_shape = shape

    @staticmethod
    def _conv_out(layer, shape):
        strides, padding, input_dilation = layer._conv_plan()
        spatial = shape[:-1]
        pads = _explicit_padding(spatial, layer.kernel_size, strides, layer.dilation, padding,
                                 input_dilation)
        ld = input_dilation or (1,) * len(spatial)
        out = tuple(((n - 1) * v + 1 + lo + hi - d * (k - 1) - 1) // s + 1
                    for n, v, (lo, hi), d, k, s in zip(spatial, ld, pads, layer.dilation,
                                                       layer.kernel_size, strides))
        return (*out, layer.features)

    def forward(self, x, qp: QuantPhase = FIXED):
        for idx, (kind, s, _, _) in enumerate(self.plan):
            if kind != "plain":
                x = getattr(self, f"layers_{idx}")(x, qp)
            elif isinstance(s, AvgPool):
                name, tie = self.pool_sites[idx]
                site = getattr(self, name)
                if qp.quant_a and tie:
                    x = site(x, qp)
                x = _pool(decoded(x), s, avg=True)
                if qp.quant_a:
                    # tied: no range update
                    x = site(x, FIXED if tie else qp)
            elif isinstance(s, MaxPool):
                x = _pool(decoded(x), s, avg=False)
            elif isinstance(s, Flatten):
                x = decoded(x)
                x = x.reshape(x.shape[0], -1)
            else:
                x = ACTIVATIONS[s.name](decoded(x))
        # chained: the last layer's codes come back as values
        return decoded(x)
