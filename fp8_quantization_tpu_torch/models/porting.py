"""Torch-checkpoint porting: FP32 state dicts of the source models -> the
port's ``state_dict`` (port of ``models/porting.py``).

The source's tensors (torchvision / the reference's CNNs, HF ViT, BERT and
Llama names) map onto the quantized model's parameters and BN buffers. BN folding
follows ``fold_bn``: a conv+BN window becomes one ``BNQuantConv`` keeping
the f32 stats, and a conv bias ahead of BN folds into ``running_mean``.

Layout changes: a torch conv kernel OIHW -> (*K, I, O) (HWIO), a linear
weight (out, in) -> (in, out), and a transposed conv's (I, O, *K) -> (*K, I,
O) with its spatial axes flipped. The input is a dict of torch tensors
(``torch.load(..., weights_only=True)``); the result is a flat dict of the
port's ``state_dict`` keys, equal to the JAX package's ported tree after
``models.bridge.from_jax_variables``. Wrap the source in :class:`UsedKeys`
to learn which of its tensors a port read.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import torch

from .mobilenet_v2 import INVERTED_RESIDUAL_SETTING
from .resnet import RESNET_SPECS

Ported = Dict[str, torch.Tensor]

# file suffixes that hold a torch state dict to port (anything else is a
# checkpoint of the port's own, ``utils.checkpoint``)
TORCH_SUFFIXES = (".pth", ".pth.tar", ".pt", ".bin")


class UsedKeys(Mapping):
    """A read-only view of a state dict that records every key read
    through ``[]`` in ``used`` (a membership test is not a read)."""

    def __init__(self, state: Mapping):
        self.state = state
        self.used = set()

    def __getitem__(self, key):
        value = self.state[key]
        self.used.add(key)
        return value

    def __contains__(self, key):
        return key in self.state

    def __iter__(self):
        return iter(self.state)

    def __len__(self):
        return len(self.state)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(device="cpu", dtype=torch.float32).contiguous()


def conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """torch (O, I, *K) -> (*K, I, O)."""
    n = w.ndim - 2
    return _f32(w.permute(*range(2, 2 + n), 1, 0))


def linear_kernel(w: torch.Tensor) -> torch.Tensor:
    """torch (out, in) -> (in, out)."""
    return _f32(w.t())


def conv_transpose_kernel(w: torch.Tensor) -> torch.Tensor:
    """torch ``ConvTranspose*d`` (I, O, *K) -> the un-flipped (*K, I, O) of
    ``QuantConvTranspose``: torch's transposed conv correlates the
    input-dilated signal with the spatially flipped kernel, so the flip
    here makes the two equal."""
    n = w.ndim - 2
    w = torch.flip(w, dims=tuple(range(2, 2 + n)))
    return _f32(w.permute(*range(2, 2 + n), 0, 1))


def conv_transpose_padding_from_torch(kernel_size, stride, padding, output_padding=0,
                                      dilation=1):
    """torch ``ConvTranspose*d`` (padding, output_padding) -> explicit (lo,
    hi) pads for ``QuantConvTranspose``: ``(d*(k-1)-p, d*(k-1)-p+op)`` per
    dim (the stride enters as input dilation, not padding)."""
    def _tup(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v,) * len(kernel_size)

    _, p, op, d = map(_tup, (stride, padding, output_padding, dilation))
    return tuple((di * (k - 1) - pi, di * (k - 1) - pi + opi)
                 for k, pi, opi, di in zip(kernel_size, p, op, d))


def _conv_bn(state: Mapping, conv: str, bn: str, dst: str) -> Ported:
    """One fold_bn window -> a ``BNQuantConv``'s kernel, gamma, beta and
    running stats under ``dst``; a conv bias folds into the mean."""
    mean = _f32(state[f"{bn}.running_mean"])
    if f"{conv}.bias" in state:
        mean = mean - _f32(state[f"{conv}.bias"])
    return {f"{dst}.kernel": conv_kernel(state[f"{conv}.weight"]),
            f"{dst}.gamma": _f32(state[f"{bn}.weight"]),
            f"{dst}.beta": _f32(state[f"{bn}.bias"]),
            f"{dst}.mean": mean,
            f"{dst}.var": _f32(state[f"{bn}.running_var"])}


def _dense(state: Mapping, src: str, dst: str, bias: bool = True) -> Ported:
    out = {f"{dst}.kernel": linear_kernel(state[f"{src}.weight"])}
    if bias:
        out[f"{dst}.bias"] = _f32(state[f"{src}.bias"])
    return out


def _layernorm(state: Mapping, src: str, dst: str) -> Ported:
    return {f"{dst}.scale": _f32(state[f"{src}.weight"]),
            f"{dst}.bias": _f32(state[f"{src}.bias"])}


def port_mobilenet_v2(state: Mapping, width_mult: float = 1.0) -> Ported:
    """The reference's FP32 MobileNetV2 (``features.{i}.conv.{j}``
    Sequentials) onto ``QuantizedMobileNetV2``."""
    out = _conv_bn(state, "features.0.0", "features.0.1", "features_0")
    idx = 1
    for t, _, n, _ in INVERTED_RESIDUAL_SETTING:
        for _ in range(n):
            base = f"features.{idx}.conv"
            # t == 1: (0 dw-conv, 1 bn, 2 relu6, 3 pw-conv, 4 bn); else
            # (0 pw, 1 bn, 2 relu6, 3 dw, 4 bn, 5 relu6, 6 pw, 7 bn)
            windows = [(0, 1), (3, 4)] if t == 1 else [(0, 1), (3, 4), (6, 7)]
            for j, (ci, bi) in enumerate(windows):
                out.update(_conv_bn(state, f"{base}.{ci}", f"{base}.{bi}",
                                    f"features_{idx}.conv_{j}"))
            idx += 1
    out.update(_conv_bn(state, f"features.{idx}.0", f"features.{idx}.1", f"features_{idx}"))
    out.update(_dense(state, "classifier.1", "classifier_1"))
    return out


def port_resnet(state: Mapping, depth: int = 18) -> Ported:
    """A torchvision ResNet onto ``QuantizedResNet``."""
    kind, reps = RESNET_SPECS[depth]
    n_convs = 2 if kind == "basic" else 3
    out = _conv_bn(state, "conv1", "bn1", "conv1")
    for li, n in enumerate(reps, start=1):
        for bi in range(n):
            src, dst = f"layer{li}.{bi}", f"layer{li}_{bi}"
            for ci in range(1, n_convs + 1):
                out.update(_conv_bn(state, f"{src}.conv{ci}", f"{src}.bn{ci}",
                                    f"{dst}.conv{ci}"))
            if f"{src}.downsample.0.weight" in state:
                out.update(_conv_bn(state, f"{src}.downsample.0", f"{src}.downsample.1",
                                    f"{dst}.downsample_0"))
    out.update(_dense(state, "fc", "fc"))
    return out


def port_vit(state: Mapping, num_layers: int = 12) -> Ported:
    """An HF ``ViTForImageClassification`` onto ``QuantizedViT``."""
    out = {"cls_token": _f32(state["vit.embeddings.cls_token"]),
           "position_embeddings": _f32(state["vit.embeddings.position_embeddings"]),
           "patch_projection.kernel": conv_kernel(
               state["vit.embeddings.patch_embeddings.projection.weight"]),
           "patch_projection.bias": _f32(
               state["vit.embeddings.patch_embeddings.projection.bias"])}
    out.update(_layernorm(state, "vit.layernorm", "layernorm"))
    out.update(_dense(state, "classifier", "classifier"))
    for i in range(num_layers):
        src, dst = f"vit.encoder.layer.{i}", f"layer_{i}"
        out.update(_layernorm(state, f"{src}.layernorm_before", f"{dst}.layernorm_before"))
        out.update(_layernorm(state, f"{src}.layernorm_after", f"{dst}.layernorm_after"))
        for name in ("query", "key", "value"):
            out.update(_dense(state, f"{src}.attention.attention.{name}",
                              f"{dst}.attention.{name}"))
        out.update(_dense(state, f"{src}.attention.output.dense", f"{dst}.attention_output"))
        out.update(_dense(state, f"{src}.intermediate.dense", f"{dst}.intermediate"))
        out.update(_dense(state, f"{src}.output.dense", f"{dst}.output"))
    return out


def port_bert(state: Mapping, num_layers: int = 12) -> Ported:
    """An HF ``BertForSequenceClassification`` onto ``QuantizedBert``."""
    out = {f"{name}_embeddings": _f32(state[f"bert.embeddings.{name}_embeddings.weight"])
           for name in ("word", "position", "token_type")}
    out.update(_layernorm(state, "bert.embeddings.LayerNorm", "embeddings_layernorm"))
    out.update(_dense(state, "bert.pooler.dense", "pooler"))
    out.update(_dense(state, "classifier", "classifier"))
    for i in range(num_layers):
        src, dst = f"bert.encoder.layer.{i}", f"layer_{i}"
        for name in ("query", "key", "value"):
            out.update(_dense(state, f"{src}.attention.self.{name}",
                              f"{dst}.attention.{name}"))
        out.update(_dense(state, f"{src}.attention.output.dense", f"{dst}.attention_output"))
        out.update(_layernorm(state, f"{src}.attention.output.LayerNorm",
                              f"{dst}.attention_layernorm"))
        out.update(_dense(state, f"{src}.intermediate.dense", f"{dst}.intermediate"))
        out.update(_dense(state, f"{src}.output.dense", f"{dst}.output"))
        out.update(_layernorm(state, f"{src}.output.LayerNorm", f"{dst}.output_layernorm"))
    return out


def port_llama(state: Mapping, num_layers: int = 32) -> Ported:
    """An HF ``LlamaForCausalLM`` onto ``QuantizedLlama``."""
    out = {"embed": _f32(state["model.embed_tokens.weight"]),
           "final_norm": _f32(state["model.norm.weight"])}
    out.update(_dense(state, "lm_head", "lm_head", bias=False))
    for i in range(num_layers):
        src, dst = f"model.layers.{i}", f"layer_{i}"
        out[f"{dst}.attn_norm"] = _f32(state[f"{src}.input_layernorm.weight"])
        out[f"{dst}.mlp_norm"] = _f32(state[f"{src}.post_attention_layernorm.weight"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out.update(_dense(state, f"{src}.self_attn.{name}", f"{dst}.{name}", bias=False))
        for name in ("gate_proj", "up_proj", "down_proj"):
            out.update(_dense(state, f"{src}.mlp.{name}", f"{dst}.{name}", bias=False))
    return out


def port_architecture(arch: str, state: Mapping, model=None) -> Ported:
    """Port ``state`` for a ``validate-quantized`` architecture (``_approx``
    twins alike), as the CLI's ``load_weights`` dispatches, or for
    ``bert_quantized`` (``nlp``'s ``--model-dir``); ``model`` (the built
    model) gives a depth-cut ViT or BERT its number of layers."""
    arch = arch.replace("_approx", "")
    if arch == "mobilenet_v2_quantized":
        return port_mobilenet_v2(state)
    if arch.startswith("resnet"):
        return port_resnet(state, 18 if "18" in arch else 50)
    if arch == "vit_quantized":
        spec = getattr(model, "spec", None)
        return port_vit(state, spec.num_layers if spec is not None else 12)
    if arch == "bert_quantized":
        spec = getattr(model, "spec", None)
        return port_bert(state, spec.num_layers if spec is not None else 12)
    raise ValueError(f"no torch porting rule for {arch}")


def merge_ported(current: Mapping, ported: Ported) -> Dict[str, torch.Tensor]:
    """``current`` (a model's ``state_dict``) with the ported tensors laid
    over it, each moved to its entry's device; a key the model lacks or a
    shape that differs raises."""
    out = dict(current)
    for key, value in ported.items():
        if key not in out:
            raise KeyError(f"the model has no entry {key}")
        if tuple(out[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(out[key].shape)} vs "
                             f"{tuple(value.shape)}")
        out[key] = value.to(out[key].device)
    return out


def unported_keys(used: UsedKeys) -> Tuple[str, ...]:
    """The source's keys a port did not read, but for the BN layers'
    ``num_batches_tracked`` counters, which carry no weight."""
    return tuple(sorted(k for k in used.state if k not in used.used
                        and not k.endswith("num_batches_tracked")))


def _bn_entries(out, name, ch, gen, counters: bool):
    out[f"{name}.weight"] = 1.0 + 0.1 * torch.randn(ch, generator=gen)
    out[f"{name}.bias"] = 0.1 * torch.randn(ch, generator=gen)
    out[f"{name}.running_mean"] = 0.1 * torch.randn(ch, generator=gen)
    out[f"{name}.running_var"] = 0.5 + torch.rand(ch, generator=gen)
    if counters:
        out[f"{name}.num_batches_tracked"] = torch.tensor(1, dtype=torch.int64)


def seeded_source_state(arch: str, generator: torch.Generator, *, spec=None,
                        conv_bias: bool = False) -> Dict[str, torch.Tensor]:
    """A seeded FP32 state dict under the source's own names and shapes, for
    checks that need a file to port and have no pretrained one: HF
    ``ViTForImageClassification`` (``vit_quantized``, ``spec`` a
    ``ViTSpec``), HF ``BertForSequenceClassification`` (``bert_quantized``,
    ``spec`` a ``BertSpec``), torchvision ResNet-18/50 (with the BN layers'
    ``num_batches_tracked``) and the reference's MobileNetV2. Kernels are
    lecun-scaled normals, BN stats near (0, 1); ``conv_bias`` adds a bias to
    every conv ahead of a BN (the fold into ``running_mean``)."""
    gen = generator
    out: Dict[str, torch.Tensor] = {}

    def conv(name, o, i, k, bias=conv_bias):
        out[f"{name}.weight"] = torch.randn(o, i, k, k, generator=gen) / (i * k * k) ** 0.5
        if bias:
            out[f"{name}.bias"] = 0.1 * torch.randn(o, generator=gen)

    def dense(name, o, i, bias=True):
        out[f"{name}.weight"] = torch.randn(o, i, generator=gen) / i ** 0.5
        if bias:
            out[f"{name}.bias"] = 0.1 * torch.randn(o, generator=gen)

    base = arch.replace("_approx", "")
    if base == "vit_quantized":
        from .vit import VIT_B_16

        s = spec or VIT_B_16
        h, tokens = s.hidden_size, (s.image_size // s.patch_size) ** 2 + 1
        out["vit.embeddings.cls_token"] = 0.02 * torch.randn(1, 1, h, generator=gen)
        out["vit.embeddings.position_embeddings"] = 0.02 * torch.randn(1, tokens, h,
                                                                      generator=gen)
        conv("vit.embeddings.patch_embeddings.projection", h, 3, s.patch_size, bias=True)
        for i in range(s.num_layers):
            src = f"vit.encoder.layer.{i}"
            for name in ("query", "key", "value"):
                dense(f"{src}.attention.attention.{name}", h, h)
            dense(f"{src}.attention.output.dense", h, h)
            dense(f"{src}.intermediate.dense", s.mlp_dim, h)
            dense(f"{src}.output.dense", h, s.mlp_dim)
            for ln in ("layernorm_before", "layernorm_after"):
                out[f"{src}.{ln}.weight"] = 1.0 + 0.1 * torch.randn(h, generator=gen)
                out[f"{src}.{ln}.bias"] = 0.1 * torch.randn(h, generator=gen)
        out["vit.layernorm.weight"] = 1.0 + 0.1 * torch.randn(h, generator=gen)
        out["vit.layernorm.bias"] = 0.1 * torch.randn(h, generator=gen)
        dense("classifier", s.num_classes, h)
        return out
    if base == "bert_quantized":
        from .bert import BERT_BASE

        s = spec or BERT_BASE
        h = s.hidden_size

        def layernorm(name):
            out[f"{name}.weight"] = 1.0 + 0.1 * torch.randn(h, generator=gen)
            out[f"{name}.bias"] = 0.1 * torch.randn(h, generator=gen)

        for name, rows in (("word", s.vocab_size), ("position", s.max_position_embeddings),
                           ("token_type", s.type_vocab_size)):
            out[f"bert.embeddings.{name}_embeddings.weight"] = 0.02 * torch.randn(
                rows, h, generator=gen)
        layernorm("bert.embeddings.LayerNorm")
        for i in range(s.num_layers):
            src = f"bert.encoder.layer.{i}"
            for name in ("query", "key", "value"):
                dense(f"{src}.attention.self.{name}", h, h)
            dense(f"{src}.attention.output.dense", h, h)
            layernorm(f"{src}.attention.output.LayerNorm")
            dense(f"{src}.intermediate.dense", s.mlp_dim, h)
            dense(f"{src}.output.dense", h, s.mlp_dim)
            layernorm(f"{src}.output.LayerNorm")
        dense("bert.pooler.dense", h, h)
        dense("classifier", s.num_classes, h)
        return out
    if base == "mobilenet_v2_quantized":
        from .mobilenet_v2 import MOBILENET_V2

        s = spec or MOBILENET_V2
        in_ch = int(32 * s.width_mult)
        conv("features.0.0", in_ch, 3, 3)
        _bn_entries(out, "features.0.1", in_ch, gen, True)
        idx = 1
        for t, c, n, _ in INVERTED_RESIDUAL_SETTING:
            out_ch = int(c * s.width_mult)
            for _ in range(n):
                hidden, base_name = in_ch * t, f"features.{idx}.conv"
                layers = ([] if t == 1 else [(0, 1, hidden, in_ch, 1)]) + [
                    (0 if t == 1 else 3, 1 if t == 1 else 4, hidden, 1, 3),
                    (3 if t == 1 else 6, 4 if t == 1 else 7, out_ch, hidden, 1)]
                for ci, bi, o, i, k in layers:
                    conv(f"{base_name}.{ci}", o, i, k)
                    _bn_entries(out, f"{base_name}.{bi}", o, gen, True)
                in_ch = out_ch
                idx += 1
        last = int(1280 * s.width_mult) if s.width_mult > 1.0 else 1280
        conv(f"features.{idx}.0", last, in_ch, 1)
        _bn_entries(out, f"features.{idx}.1", last, gen, True)
        dense("classifier.1", s.num_classes, last)
        return out
    if base in ("resnet18_quantized", "resnet50_quantized"):
        depth = 18 if "18" in base else 50
        kind, reps = RESNET_SPECS[depth]
        classes = spec.num_classes if spec is not None else 1000
        expansion = 1 if kind == "basic" else 4
        conv("conv1", 64, 3, 7)
        _bn_entries(out, "bn1", 64, gen, True)
        in_ch = 64
        for li, (width, n) in enumerate(zip((64, 128, 256, 512), reps), start=1):
            for bi in range(n):
                src, out_ch = f"layer{li}.{bi}", width * expansion
                shapes = ([(width, in_ch, 3), (width, width, 3)] if kind == "basic" else
                          [(width, in_ch, 1), (width, width, 3), (out_ch, width, 1)])
                for ci, (o, i, k) in enumerate(shapes, start=1):
                    conv(f"{src}.conv{ci}", o, i, k)
                    _bn_entries(out, f"{src}.bn{ci}", o, gen, True)
                if bi == 0 and (li > 1 or in_ch != out_ch):
                    conv(f"{src}.downsample.0", out_ch, in_ch, 1)
                    _bn_entries(out, f"{src}.downsample.1", out_ch, gen, True)
                in_ch = out_ch
        dense("fc", classes, in_ch)
        return out
    raise ValueError(f"no source layout for {arch}")
