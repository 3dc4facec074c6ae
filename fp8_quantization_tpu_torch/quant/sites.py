"""QuantSite: one quantized tensor site as an ``nn.Module`` (port of
``quant/sites.py``).

The JAX package keeps a site's state in the flax ``quant`` / ``quant_est``
collections; here it is the module's buffers (``maxval``, ``mantissa_bits``,
``sign_bits`` and ``xmin``, ``xmax``, ``count``), which ``state_dict`` and
``models.bridge`` address by the same path. The call carries a phase:

* ``ESTIMATE`` folds the batch into the range estimator, sets the quantizer
  range (updating the buffers in place), then quantizes;
* ``FIXED`` quantizes with the frozen state.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import LATER as _LATER
from ..config import EstimatorConfig, QMethod, QuantizerConfig
from . import estimators, quantizers


@dataclasses.dataclass(frozen=True)
class QuantPhase:
    """Static per-call quantization context. The serving fields of the JAX
    package's phase are kept by name; setting one raises until its slice
    (the packed/chained serving currencies, the fused SDPA kernel) lands."""

    phase: str = "fixed"  # "estimate" | "fixed"
    quant_w: bool = True
    quant_a: bool = True
    grad_scaling: bool = False
    reestimate_bn: bool = False
    cache_weights: bool = False
    fast: bool = False
    packed: bool = False
    chained: bool = False
    fused_sdpa: "bool | None" = None

    def __post_init__(self):
        if self.phase not in ("estimate", "fixed"):
            raise ValueError(f"unknown phase {self.phase!r}")
        for name in ("grad_scaling", "reestimate_bn", "cache_weights", "fast",
                     "packed", "chained"):
            if getattr(self, name):
                raise NotImplementedError(f"QuantPhase.{name} {_LATER}")
        if self.fused_sdpa:
            raise NotImplementedError(f"the fused SDPA kernel (K7) {_LATER}")

    @property
    def estimating(self) -> bool:
        return self.phase == "estimate"


FP32 = QuantPhase(quant_w=False, quant_a=False)
ESTIMATE = QuantPhase(phase="estimate")
FIXED = QuantPhase(phase="fixed")


class QuantSite(nn.Module):
    """Quantizer + range estimator for one tensor site.

    ``num_channels`` is the size of ``channel_axis`` for a per-channel site
    (ignored per-tensor): torch buffers need their shape up front, where the
    flax site took it from its first input.
    """

    _Q_KEYS = ("maxval", "mantissa_bits", "sign_bits")
    _EST_KEYS = ("xmin", "xmax", "count")

    def __init__(self, qcfg: QuantizerConfig, ecfg: EstimatorConfig,
                 channel_axis: int = -1, num_channels: int = 1, device=None):
        super().__init__()
        self.qcfg = qcfg
        self.ecfg = ecfg
        self.channel_axis = channel_axis
        c = num_channels if qcfg.per_channel else 1
        for k, v in quantizers.init(qcfg, c, device).items():
            self.register_buffer(k, v)
        for k, v in estimators.init(ecfg, qcfg, c, device).items():
            self.register_buffer(k, v)

    def _state(self, keys):
        return {k: getattr(self, k) for k in keys}

    def forward(self, x, qp: QuantPhase = FIXED, *, with_bias: bool = False):
        """Quantize ``x``; returns ``y`` or ``(y, bias)`` when ``with_bias``
        (the approx-matmul path needs the derived exponent bias)."""
        x = x.to(torch.float32)
        per_channel = self.qcfg.per_channel
        q = self._state(self._Q_KEYS)
        if qp.estimating:
            new_est, (x_min, x_max, _) = estimators.update(
                self.ecfg, self.qcfg, self._state(self._EST_KEYS), x.detach(),
                per_channel, self.channel_axis)
            q = quantizers.set_quant_range(self.qcfg, q, x_min, x_max)
            with torch.no_grad():
                for k, v in {**q, **new_est}.items():
                    getattr(self, k).copy_(v)
            q = self._state(self._Q_KEYS)
        y, bias = quantizers.fp_apply(self.qcfg, q, x, self.channel_axis)
        return (y, bias) if with_bias else y

    def fp_bias(self):
        """Derived exponent bias from the current state."""
        if self.qcfg.method != QMethod.fp_quantizer:
            return None
        return quantizers.fp_bias(self.qcfg, self._state(self._Q_KEYS))
