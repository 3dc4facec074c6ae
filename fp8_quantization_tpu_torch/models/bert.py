"""Quantized BERT-base for sequence classification (GLUE), port of
``models/bert.py``.

The site placement of the quantized ViT, on a post-LN encoder:

* word / position / token-type embedding lookups, summed, feed a
  QuantLayerNorm
* per block: q/k/v QuantDense -> unquantized scaled-dot-product attention
  with the attention mask's bias -> site on the context -> output
  QuantDense -> residual add -> QuantLayerNorm; intermediate QuantDense +
  GELU + site -> output QuantDense -> residual add -> QuantLayerNorm
* pooler QuantDense + tanh on the first token, classifier QuantDense

Submodule and parameter names are the flax ones, so ``state_dict`` keys are
the flax variable paths joined with dots (``models.bridge``). Weights from
an HF ``BertForSequenceClassification`` state dict go through
``models.porting.port_bert``.

The attention is the einsum path in f32, in every phase, as in the JAX
package (BERT takes no fused SDPA kernel). The sites of this model pass no
chained codes between layers (as the JAX model's, whose bare sites are
called without ``as_codes``): a dense layer's res site may, and every
consumer decodes them. Elementwise ops keep the JAX model's dtype rules:
the residual adds promote as ``h + x`` does (bf16 + bf16 stays bf16 under
``FAST`` when the input is not quantized), and the mask's bias takes the
dtype of the block input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..config import QuantConfig
from ..ops.activations import ACTIVATIONS
from ..ops.layers import QuantDense, QuantLayerNorm
from ..quant.sites import FIXED, QuantPhase, QuantSite, coded_shape, decoded


@dataclasses.dataclass(frozen=True)
class BertSpec:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    num_classes: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"


BERT_BASE = BertSpec()


class _ActSite(nn.Module):
    """A bare activation quantization site (values, never chained codes)."""

    def __init__(self, qc: QuantConfig, device=None):
        super().__init__()
        self.activation_quantizer = QuantSite(qc.act_quantizer(), qc.act_range,
                                              device=device)

    def forward(self, x, qp: QuantPhase = FIXED):
        if qp.quant_a:
            x = self.activation_quantizer(x, qp)
        return x


def _value_dtype(x):
    """The dtype of ``x`` as a value: a tensor's own, f32 for codes."""
    return x.dtype if isinstance(x, torch.Tensor) else torch.float32


def mask_bias(attention_mask, x):
    """``(1 - mask) * -1e9`` broadcast over heads and queries, in the dtype
    of the block input ``x``, as the JAX model computes it: bf16 where a
    fast-mode site hands bf16 values on."""
    m = attention_mask[:, None, None, :].to(_value_dtype(x))
    return (1.0 - m) * -1e9


class QuantBertSelfAttention(nn.Module):
    """q/k/v projections quantized; the masked attention unquantized, in f32."""

    def __init__(self, qc: QuantConfig, spec: BertSpec, generator=None, device=None):
        super().__init__()
        self.spec = spec
        h = spec.hidden_size
        # the f32 square root of the head width, as the JAX model divides by
        self.scale = float(np.sqrt(np.float32(h // spec.num_heads), dtype=np.float32))
        kw = dict(generator=generator, device=device)
        self.query = QuantDense(qc, h, h, **kw)
        self.key = QuantDense(qc, h, h, **kw)
        self.value = QuantDense(qc, h, h, **kw)
        self.context_site = _ActSite(qc, device)

    def forward(self, x, attention_mask, qp: QuantPhase = FIXED):
        s = self.spec
        head_dim = s.hidden_size // s.num_heads
        b, t, _ = coded_shape(x)
        q, k, v = self.query(x, qp), self.key(x, qp), self.value(x, qp)

        def split(u):
            # fast-mode outputs arrive as bf16 grid values: exact in f32
            u = decoded(u).to(torch.float32)
            return u.reshape(b, t, s.num_heads, head_dim).transpose(1, 2)

        qh, kh, vh = split(q), split(k), split(v)
        scores = torch.matmul(qh, kh.transpose(-1, -2)) / self.scale
        if attention_mask is not None:
            scores = scores + mask_bias(attention_mask, x)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs, vh)
        ctx = ctx.transpose(1, 2).reshape(b, t, s.hidden_size)
        return self.context_site(ctx, qp)


class QuantBertBlock(nn.Module):
    """One post-LN encoder layer."""

    def __init__(self, qc: QuantConfig, spec: BertSpec, generator=None, device=None):
        super().__init__()
        self.qc = qc
        h = spec.hidden_size
        kw = dict(generator=generator, device=device)
        eps = spec.layer_norm_eps
        self.act = ACTIVATIONS[spec.hidden_act]
        self.attention = QuantBertSelfAttention(qc, spec, **kw)
        self.attention_output = QuantDense(qc, h, h, **kw)
        self.attention_layernorm = QuantLayerNorm(qc, h, epsilon=eps, device=device)
        # with quantize_input the GELU fuses into the dense (the next site
        # quantizes it); otherwise it follows the dense's output site
        self.intermediate = QuantDense(
            qc, h, spec.mlp_dim, activation=self.act if qc.quantize_input else None, **kw)
        self.intermediate_site = _ActSite(qc, device)
        self.output = QuantDense(qc, spec.mlp_dim, h, **kw)
        self.output_layernorm = QuantLayerNorm(qc, h, epsilon=eps, device=device)

    def forward(self, x, attention_mask, qp: QuantPhase = FIXED):
        h = self.attention(x, attention_mask, qp)
        h = self.attention_output(h, qp)
        x = self.attention_layernorm(decoded(h) + decoded(x), qp)

        y = self.intermediate(x, qp)
        if not self.qc.quantize_input:
            y = self.act(decoded(y))
        y = self.intermediate_site(y, qp)
        y = self.output(y, qp)
        return self.output_layernorm(decoded(y) + decoded(x), qp)


class QuantizedBert(nn.Module):
    """BERT for sequence classification: token ids (B, T) in, logits out.

    Weights are drawn from ``generator`` (flax's initializers: normal(0.02)
    embeddings, lecun-normal kernels, zero biases, unit LayerNorm scales);
    load trained ones through ``models.porting.port_bert``.
    """

    def __init__(self, qc: QuantConfig, spec: BertSpec = BERT_BASE, generator=None,
                 device=None):
        super().__init__()
        self.qc = qc
        self.spec = spec
        s = spec
        kw = dict(generator=generator, device=device)

        def embedding(rows):
            w = torch.empty(rows, s.hidden_size, device=device)
            return nn.Parameter(w.normal_(0.0, 0.02, generator=generator))

        self.word_embeddings = embedding(s.vocab_size)
        self.position_embeddings = embedding(s.max_position_embeddings)
        self.token_type_embeddings = embedding(s.type_vocab_size)
        self.embeddings_layernorm = QuantLayerNorm(qc, s.hidden_size,
                                                   epsilon=s.layer_norm_eps, device=device)
        for i in range(s.num_layers):
            setattr(self, f"layer_{i}", QuantBertBlock(qc, s, **kw))
        self.pooler = QuantDense(qc, s.hidden_size, s.hidden_size, activation=torch.tanh,
                                 **kw)
        self.classifier = QuantDense(qc, s.hidden_size, s.num_classes, **kw)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                qp: QuantPhase = FIXED):
        s = self.spec
        ids = input_ids.long()
        t = ids.shape[1]
        types = torch.zeros_like(ids) if token_type_ids is None else token_type_ids.long()
        positions = torch.arange(t, device=ids.device)
        emb = (self.word_embeddings[ids] + self.position_embeddings[positions][None]
               + self.token_type_embeddings[types])
        h = self.embeddings_layernorm(emb, qp)
        for i in range(s.num_layers):
            h = getattr(self, f"layer_{i}")(h, attention_mask, qp)
        pooled = self.pooler(h[:, 0, :], qp)
        return decoded(self.classifier(pooled, qp))
