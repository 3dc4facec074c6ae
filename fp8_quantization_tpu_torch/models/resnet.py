"""Quantized ResNet-18/34/50/101/152 (port of ``models/resnet.py``): NHWC
images in, logits out.

Every conv+BN(+ReLU) window is a ``BNQuantConv``. A block adds its residual,
applies ReLU, then requantizes through its own activation site; the last
block's site is hoisted to the model (``layer4_{n-1}_activation_quantizer``)
and tied to the adaptive average pool: it quantizes the block's output
(updating its ranges) and the pool's output with ``FIXED``, without
updating them. The max-pool after the stem stays unquantized f32 (padded
with -inf). ``quant_setup`` variants: all, FP_logits, fc4, LSQ, LSQ_paper.

Submodule and parameter names are the flax ones (``conv1``,
``layer{l}_{b}``, ``downsample_0``, ``fc``), so ``models.bridge`` carries
the JAX variables across as a rename.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..config import QuantConfig
from ..ops.layers import BNQuantConv, QuantDense
from ..quant.sites import FIXED, QuantPhase, QuantSite, decoded

RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
WIDTHS = (64, 128, 256, 512)

_NO_PAD = [(0, 0), (0, 0)]
_PAD_1 = [(1, 1), (1, 1)]


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    depth: int = 18
    num_classes: int = 1000
    image_size: int = 224


RESNET18 = ResNetSpec(depth=18)
RESNET50 = ResNetSpec(depth=50)


class _Block(nn.Module):
    """The residual tail shared by both block kinds: an optional 1x1
    ``downsample_0`` on the shortcut, and the add, ReLU and site."""

    def __init__(self, qc: QuantConfig, in_ch: int, out_ch: int, stride: int,
                 downsample: bool, quantize_residual: bool, kw):
        super().__init__()
        self.quantize_residual = quantize_residual
        if downsample:
            self.downsample_0 = BNQuantConv(qc, in_ch, out_ch, kernel_size=(1, 1),
                                            strides=(stride, stride), padding=_NO_PAD,
                                            use_bias=False, **kw)
        else:
            self.downsample_0 = None
        if quantize_residual:
            self.activation_quantizer = QuantSite(qc.act_quantizer(), qc.act_range,
                                                  device=kw["device"])

    def _residual(self, x, y, qp: QuantPhase):
        shortcut = x if self.downsample_0 is None else self.downsample_0(x, qp)
        y = torch.relu(decoded(y) + decoded(shortcut))
        if qp.quant_a and self.quantize_residual:
            y = self.activation_quantizer(y, qp)
        return y


class QuantBasicBlock(_Block):
    """BasicBlock: 3x3 + 3x3 with residual."""

    def __init__(self, qc: QuantConfig, in_ch: int, features: int, *, stride: int = 1,
                 downsample: bool = False, quantize_residual: bool = True,
                 generator=None, device=None):
        kw = dict(generator=generator, device=device)
        super().__init__(qc, in_ch, features, stride, downsample, quantize_residual, kw)
        self.conv1 = BNQuantConv(qc, in_ch, features, kernel_size=(3, 3),
                                 strides=(stride, stride), padding=_PAD_1, use_bias=False,
                                 activation=torch.relu, **kw)
        self.conv2 = BNQuantConv(qc, features, features, kernel_size=(3, 3), strides=(1, 1),
                                 padding=_PAD_1, use_bias=False, **kw)

    def forward(self, x, qp: QuantPhase = FIXED):
        return self._residual(x, self.conv2(self.conv1(x, qp), qp), qp)


class QuantBottleneck(_Block):
    """Bottleneck: 1x1 -> 3x3 -> 1x1 (x4) with residual."""

    expansion = 4

    def __init__(self, qc: QuantConfig, in_ch: int, width: int, *, stride: int = 1,
                 downsample: bool = False, quantize_residual: bool = True,
                 generator=None, device=None):
        kw = dict(generator=generator, device=device)
        out_ch = width * self.expansion
        super().__init__(qc, in_ch, out_ch, stride, downsample, quantize_residual, kw)
        self.conv1 = BNQuantConv(qc, in_ch, width, kernel_size=(1, 1), strides=(1, 1),
                                 padding=_NO_PAD, use_bias=False, activation=torch.relu, **kw)
        self.conv2 = BNQuantConv(qc, width, width, kernel_size=(3, 3),
                                 strides=(stride, stride), padding=_PAD_1, use_bias=False,
                                 activation=torch.relu, **kw)
        self.conv3 = BNQuantConv(qc, width, out_ch, kernel_size=(1, 1), strides=(1, 1),
                                 padding=_NO_PAD, use_bias=False, **kw)

    def forward(self, x, qp: QuantPhase = FIXED):
        y = self.conv3(self.conv2(self.conv1(x, qp), qp), qp)
        return self._residual(x, y, qp)


def overrides(quant_setup):
    """(stem's weight bits, fc's weight bits, FP32 logits, quantized
    residual adds) of a ``quant_setup``."""
    first_w = last_w = None
    fp_logits = False
    quantize_residual = True
    if quant_setup == "FP_logits":
        fp_logits = True
    elif quant_setup == "fc4":
        first_w, last_w = 8, 4
    elif quant_setup in ("LSQ", "LSQ_paper"):
        first_w, last_w = 8, 8
        fp_logits = quant_setup == "LSQ"
        quantize_residual = quant_setup != "LSQ_paper"
    elif quant_setup not in (None, "all"):
        raise ValueError(f"Quantization setup '{quant_setup}' not supported for Resnet")
    return first_w, last_w, fp_logits, quantize_residual


class QuantizedResNet(nn.Module):
    """ResNet with quantized convs and classifier. Weights are drawn from
    ``generator`` (flax's initializers); load trained ones through
    ``load_state_dict``."""

    def __init__(self, qc: QuantConfig, spec: ResNetSpec = RESNET18, generator=None,
                 device=None):
        super().__init__()
        self.qc = qc
        self.spec = spec
        kind, reps = RESNET_SPECS[spec.depth]
        block = QuantBasicBlock if kind == "basic" else QuantBottleneck
        expansion = 1 if kind == "basic" else QuantBottleneck.expansion
        first_w, last_w, fp_logits, self.quantize_residual = overrides(qc.quant_setup)
        kw = dict(generator=generator, device=device)

        self.conv1 = BNQuantConv(qc, 3, 64, kernel_size=(7, 7), strides=(2, 2),
                                 padding=[(3, 3), (3, 3)], use_bias=False,
                                 activation=torch.relu, n_bits_w=first_w, **kw)
        in_ch = 64
        self.block_names = []
        for li, (width, n) in enumerate(zip(WIDTHS, reps)):
            for bi in range(n):
                stride = (1 if li == 0 else 2) if bi == 0 else 1
                out_ch = width * expansion
                name = f"layer{li + 1}_{bi}"
                is_last = li == len(reps) - 1 and bi == n - 1
                setattr(self, name, block(
                    qc, in_ch, width, stride=stride,
                    downsample=stride != 1 or in_ch != out_ch,
                    # the last block's site is hoisted so the pool can tie to it
                    quantize_residual=self.quantize_residual and not is_last, **kw))
                self.block_names.append(name)
                in_ch = out_ch
        self.pool_site_name = f"{self.block_names[-1]}_activation_quantizer"
        setattr(self, self.pool_site_name,
                QuantSite(qc.act_quantizer(), qc.act_range, device=device))
        self.fc = QuantDense(qc, in_ch, spec.num_classes, n_bits_w=last_w,
                             quantize_output=not fp_logits, **kw)

    def forward(self, x, qp: QuantPhase = FIXED):
        x = self.conv1(x, qp)
        x = F.max_pool2d(decoded(x).permute(0, 3, 1, 2), 3, stride=2,
                         padding=1).permute(0, 2, 3, 1)
        for name in self.block_names:
            x = getattr(self, name)(x, qp)
        pool_site = getattr(self, self.pool_site_name)
        tied = qp.quant_a and self.quantize_residual
        if tied:
            x = pool_site(x, qp)
        x = torch.mean(x, dim=(1, 2))
        if tied:
            x = pool_site(x, FIXED)
        return decoded(self.fc(x, qp))
