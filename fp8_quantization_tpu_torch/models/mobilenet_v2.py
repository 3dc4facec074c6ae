"""Quantized MobileNetV2 (port of ``models/mobilenet_v2.py``): NHWC images
in, logits out.

Every conv+BN(+ReLU6) window is a ``BNQuantConv`` (the depthwise ones with
``feature_group_count`` = channels); a residual add is requantized through
its block's own activation site; the last 1x1 conv's output site is hoisted
to the model (``features_{18}_activation_quantizer``) so that the average
pool can tie to it: without ``quantize_input`` the site quantizes the conv's
output (updating its ranges) and then the pool's output with ``FIXED``,
without updating them; with ``quantize_input`` it quantizes only the pool's
output, in the call's own phase.

``quant_setup`` variants (all, FP_logits, fc4, fc4_dw8, LSQ, LSQ_paper) set
per-layer weight bits and output quantization as in the JAX package.
Submodule and parameter names are the flax ones (``features_{i}``,
``conv_{j}``, ``classifier_1``), so ``models.bridge`` carries the JAX
variables across as a rename.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.nn.functional as F
from torch import nn

from ..config import QuantConfig
from ..ops.activations import relu6
from ..ops.layers import BNQuantConv, QuantDense
from ..quant.sites import FIXED, QuantPhase, QuantSite, decoded

# (expansion t, channels c, repeats n, stride s)
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

_NO_PAD = [(0, 0), (0, 0)]
_PAD_1 = [(1, 1), (1, 1)]


@dataclasses.dataclass(frozen=True)
class MobileNetV2Spec:
    num_classes: int = 1000
    width_mult: float = 1.0
    image_size: int = 224   # the JAX model's ``input_size``


MOBILENET_V2 = MobileNetV2Spec()


class QuantInvertedResidual(nn.Module):
    """Inverted residual block: 1x1 expand (unless ``expand_ratio`` is 1),
    3x3 depthwise, 1x1 linear projection, and the residual add with its
    own activation site where the block keeps its shape."""

    def __init__(self, qc: QuantConfig, in_ch: int, out_ch: int, stride: int,
                 expand_ratio: int, *, n_bits_dw: Optional[int] = None,
                 quantize_residual: bool = True, generator=None, device=None):
        super().__init__()
        self.qc = qc
        self.quantize_residual = quantize_residual
        self.use_res = stride == 1 and in_ch == out_ch
        hidden = round(in_ch * expand_ratio)
        kw = dict(use_bias=False, generator=generator, device=device)
        convs = []
        if expand_ratio != 1:
            convs.append(BNQuantConv(qc, in_ch, hidden, kernel_size=(1, 1), strides=(1, 1),
                                     padding=_NO_PAD, activation=relu6, **kw))
        convs.append(BNQuantConv(qc, hidden, hidden, kernel_size=(3, 3),
                                 strides=(stride, stride), padding=_PAD_1,
                                 feature_group_count=hidden, activation=relu6,
                                 n_bits_w=n_bits_dw, **kw))
        convs.append(BNQuantConv(qc, hidden, out_ch, kernel_size=(1, 1), strides=(1, 1),
                                 padding=_NO_PAD, **kw))
        self.n_convs = len(convs)
        for i, conv in enumerate(convs):
            setattr(self, f"conv_{i}", conv)
        if self.use_res and quantize_residual:
            self.activation_quantizer = QuantSite(qc.act_quantizer(), qc.act_range,
                                                  device=device)

    def forward(self, x, qp: QuantPhase = FIXED):
        y = x
        for i in range(self.n_convs):
            y = getattr(self, f"conv_{i}")(y, qp)
        if self.use_res:
            y = decoded(x) + decoded(y)
            if qp.quant_a and self.quantize_residual:
                y = self.activation_quantizer(y, qp)
        return y


def setup_overrides(quant_setup):
    """(first conv's weight bits, classifier's weight bits, depthwise weight
    bits, FP32 logits, quantized residual adds) of a ``quant_setup``."""
    first_w = last_w = dw_bits = None
    fp_logits = False
    quantize_residual = True
    if quant_setup == "FP_logits":
        fp_logits = True
    elif quant_setup == "fc4":
        first_w, last_w = 8, 4
    elif quant_setup == "fc4_dw8":
        first_w, last_w, dw_bits = 8, 4, 8
    elif quant_setup in ("LSQ", "LSQ_paper"):
        first_w, last_w = 8, 8
        fp_logits = quant_setup == "LSQ"
        quantize_residual = quant_setup != "LSQ_paper"
    elif quant_setup not in (None, "all"):
        raise ValueError(f"Quantization setup '{quant_setup}' not supported for MobilenetV2")
    return first_w, last_w, dw_bits, fp_logits, quantize_residual


class QuantizedMobileNetV2(nn.Module):
    """MobileNetV2 with quantized convs and classifier. Weights are drawn
    from ``generator`` (flax's initializers: lecun-normal kernels, zero
    biases, unit BN scales); load trained ones through ``load_state_dict``."""

    def __init__(self, qc: QuantConfig, spec: MobileNetV2Spec = MOBILENET_V2,
                 generator=None, device=None):
        super().__init__()
        self.qc = qc
        self.spec = spec
        first_w, last_w, dw_bits, fp_logits, quantize_residual = setup_overrides(
            qc.quant_setup)
        kw = dict(generator=generator, device=device)
        in_ch = int(32 * spec.width_mult)
        last_channel = int(1280 * spec.width_mult) if spec.width_mult > 1.0 else 1280

        self.features_0 = BNQuantConv(qc, 3, in_ch, kernel_size=(3, 3), strides=(2, 2),
                                      padding=_PAD_1, use_bias=False, activation=relu6,
                                      n_bits_w=first_w, **kw)
        idx = 1
        for t, c, n, s in INVERTED_RESIDUAL_SETTING:
            out_ch = int(c * spec.width_mult)
            for i in range(n):
                setattr(self, f"features_{idx}", QuantInvertedResidual(
                    qc, in_ch, out_ch, s if i == 0 else 1, t, n_bits_dw=dw_bits,
                    quantize_residual=quantize_residual, **kw))
                in_ch = out_ch
                idx += 1
        self.n_blocks = idx - 1
        # the last 1x1 conv's output site is hoisted so the pool can tie to it
        setattr(self, f"features_{idx}", BNQuantConv(
            qc, in_ch, last_channel, kernel_size=(1, 1), strides=(1, 1), padding=_NO_PAD,
            use_bias=False, activation=relu6, quantize_output=False, **kw))
        setattr(self, f"features_{idx}_activation_quantizer",
                QuantSite(qc.act_quantizer(), qc.act_range, device=device))
        self.classifier_1 = QuantDense(qc, last_channel, spec.num_classes,
                                       n_bits_w=last_w, quantize_output=not fp_logits, **kw)

    def forward(self, x, qp: QuantPhase = FIXED):
        last = self.n_blocks + 1
        x = self.features_0(x, qp)
        for i in range(1, last):
            x = getattr(self, f"features_{i}")(x, qp)
        x = getattr(self, f"features_{last}")(x, qp)

        tie = not self.qc.quantize_input
        pool_site = getattr(self, f"features_{last}_activation_quantizer")
        if qp.quant_a and tie:
            x = pool_site(x, qp)
        win = self.spec.image_size // 32
        x = F.avg_pool2d(decoded(x).permute(0, 3, 1, 2), win, stride=win).permute(0, 2, 3, 1)
        if qp.quant_a:
            # tied: quantize without updating the ranges
            x = pool_site(x, FIXED if tie else qp)
        x = x.reshape(x.shape[0], -1)
        return decoded(self.classifier_1(x, qp))
