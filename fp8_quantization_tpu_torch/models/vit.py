"""Quantized ViT-B/16 (the HF ``google/vit-base-patch16-224`` architecture),
port of ``models/vit.py`` on its einsum attention path.

Quantization sites, as in the JAX package:

* patch-embedding conv (QuantConv) + a site on the embedding tokens
* a site after the cls-token / position-embedding add
* per block: QuantLayerNorm (gamma as weight) -> q/k/v QuantDense ->
  unquantized scaled-dot-product attention -> site on the context -> output
  QuantDense -> residual add + site -> QuantLayerNorm -> intermediate
  QuantDense + GELU + site -> output QuantDense + residual add + site
* a site after the encoder stack, final QuantLayerNorm, classifier
  QuantDense on the CLS token

Submodule and parameter names are the flax ones, so ``state_dict`` keys are
the flax variable paths joined with dots (``models.bridge``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..config import QuantConfig
from ..ops.activations import ACTIVATIONS
from ..ops.layers import QuantConv, QuantDense, QuantLayerNorm
from ..quant.sites import FIXED, QuantPhase, QuantSite


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    patch_size: int = 16
    image_size: int = 224
    num_classes: int = 1000
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"


VIT_B_16 = ViTSpec()


class _ActSite(nn.Module):
    """A bare activation quantization site."""

    def __init__(self, qc: QuantConfig, device=None):
        super().__init__()
        self.activation_quantizer = QuantSite(qc.act_quantizer(), qc.act_range,
                                              device=device)

    def forward(self, x, qp: QuantPhase = FIXED):
        if qp.quant_a:
            x = self.activation_quantizer(x, qp)
        return x


class QuantViTSelfAttention(nn.Module):
    """q/k/v projections quantized; the attention itself unquantized."""

    def __init__(self, qc: QuantConfig, spec: ViTSpec, generator=None, device=None):
        super().__init__()
        self.spec = spec
        h = spec.hidden_size
        kw = dict(generator=generator, device=device)
        self.query = QuantDense(qc, h, h, **kw)
        self.key = QuantDense(qc, h, h, **kw)
        self.value = QuantDense(qc, h, h, **kw)
        self.context_site = _ActSite(qc, device)

    def forward(self, x, qp: QuantPhase = FIXED):
        s = self.spec
        head_dim = s.hidden_size // s.num_heads
        q, k, v = self.query(x, qp), self.key(x, qp), self.value(x, qp)
        b, t, _ = x.shape

        def split(u):
            return u.reshape(b, t, s.num_heads, head_dim).transpose(1, 2)

        qh, kh, vh = split(q), split(k), split(v)
        scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(head_dim)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs, vh)
        ctx = ctx.transpose(1, 2).reshape(b, t, s.hidden_size)
        return self.context_site(ctx, qp)


class QuantViTBlock(nn.Module):
    """One encoder layer."""

    def __init__(self, qc: QuantConfig, spec: ViTSpec, generator=None, device=None):
        super().__init__()
        self.qc = qc
        self.spec = spec
        h = spec.hidden_size
        kw = dict(generator=generator, device=device)
        self.act = ACTIVATIONS[spec.hidden_act]
        self.layernorm_before = QuantLayerNorm(qc, h, epsilon=spec.layer_norm_eps,
                                               device=device)
        self.attention = QuantViTSelfAttention(qc, spec, **kw)
        self.attention_output = QuantDense(qc, h, h, **kw)
        self.residual1_site = _ActSite(qc, device)
        self.layernorm_after = QuantLayerNorm(qc, h, epsilon=spec.layer_norm_eps,
                                              device=device)
        # with quantize_input the GELU fuses into the dense (its output is
        # quantized by the next site); otherwise it follows the dense's own
        # output quantization
        self.intermediate = QuantDense(
            qc, h, spec.mlp_dim,
            activation=self.act if qc.quantize_input else None, **kw)
        self.intermediate_site = _ActSite(qc, device)
        self.output = QuantDense(qc, spec.mlp_dim, h, **kw)
        self.residual2_site = _ActSite(qc, device)

    def forward(self, x, qp: QuantPhase = FIXED):
        h = self.layernorm_before(x, qp)
        h = self.attention(h, qp)
        h = self.attention_output(h, qp)
        x = self.residual1_site(h + x, qp)

        y = self.layernorm_after(x, qp)
        y = self.intermediate(y, qp)
        if not self.qc.quantize_input:
            y = self.act(y)
        y = self.intermediate_site(y, qp)
        y = self.output(y, qp)
        return self.residual2_site(y + x, qp)


class QuantizedViT(nn.Module):
    """ViT for image classification: NHWC images in, logits out.

    Weights are drawn from ``generator`` (flax's initializers: lecun-normal
    kernels, zero biases, cls token and position embeddings, unit LayerNorm
    scales); load trained ones through ``load_state_dict``.
    """

    def __init__(self, qc: QuantConfig, spec: ViTSpec = VIT_B_16, generator=None,
                 device=None):
        super().__init__()
        self.qc = qc
        self.spec = spec
        s = spec
        kw = dict(generator=generator, device=device)
        p = s.patch_size
        self.patch_projection = QuantConv(
            qc, 3, s.hidden_size, kernel_size=(p, p), strides=(p, p),
            padding=[(0, 0), (0, 0)], use_bias=True, **kw)
        self.patch_site = _ActSite(qc, device)
        n_tokens = (s.image_size // p) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, s.hidden_size, device=device))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, n_tokens, s.hidden_size, device=device))
        self.embeddings_site = _ActSite(qc, device)
        for i in range(s.num_layers):
            setattr(self, f"layer_{i}", QuantViTBlock(qc, s, **kw))
        self.encoder_site = _ActSite(qc, device)
        self.layernorm = QuantLayerNorm(qc, s.hidden_size, epsilon=s.layer_norm_eps,
                                        device=device)
        self.classifier = QuantDense(qc, s.hidden_size, s.num_classes, **kw)

    def forward(self, x, qp: QuantPhase = FIXED):
        s = self.spec
        b = x.shape[0]
        emb = self.patch_projection(x, qp).reshape(b, -1, s.hidden_size)
        emb = self.patch_site(emb, qp)
        cls = self.cls_token.expand(b, 1, s.hidden_size)
        emb = torch.cat([cls, emb], dim=1) + self.position_embeddings
        h = self.embeddings_site(emb, qp)
        for i in range(s.num_layers):
            h = getattr(self, f"layer_{i}")(h, qp)
        h = self.encoder_site(h, qp)
        h = self.layernorm(h, qp)
        return self.classifier(h[:, 0, :], qp)
