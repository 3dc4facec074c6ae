"""Demo model: the smallest end-to-end quantized pipeline (port of
``models/demo.py``): one 10->10 ``QuantDense`` named ``fc``, which
``validate-quantized-demo`` runs on seeded (B, 10) normal inputs."""

from __future__ import annotations

from torch import nn

from ..config import QuantConfig
from ..ops.layers import QuantDense
from ..quant.sites import FIXED, QuantPhase, decoded


class QuantizedDemoModel(nn.Module):
    def __init__(self, qc: QuantConfig, features: int = 10, *, generator=None, device=None):
        super().__init__()
        self.qc = qc
        self.features = features
        self.fc = QuantDense(qc, features, features, generator=generator, device=device)

    def forward(self, x, qp: QuantPhase = FIXED):
        # chained: the logits come back as codes
        return decoded(self.fc(x, qp))
