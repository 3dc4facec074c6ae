"""Inference fast path, FP part (port of ``ops/fastpath.py``): frozen
per-tensor quantizer scalars, the fused quantized matmul, and the byte
packing of cached dense weights for the packed-FP8 serving path.

``finalize_dense`` turns a calibrated ``QuantDense`` into fast-path params:
weights pre-quantized onto their ExMy grid as bfloat16 (exact for
mant_width <= 7) and per-tensor act/res quantizers reduced to
``(maxval, bias, mant, sign)`` scalars. ``quantized_matmul`` is the fast
mode's one dense product: the fused quant GEMM (K2), with the bit-ops
quantizer (K1) on x on the load and on the result. ``QuantDense`` runs it
under ``fast``. The uniform (int8/int4) serving currency belongs to a later
slice and raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import LATER as _LATER
from ..config import QMethod, QuantConfig
from ..numerics.rounding import to_int32
from ..quant import quantizers
from .cuda import fused_matmul as k2


class ScalarQuantParams(NamedTuple):
    maxval: torch.Tensor   # f32 scalar
    bias: torch.Tensor     # i32 scalar
    mant: torch.Tensor     # i32 scalar
    sign: torch.Tensor     # i32 scalar


class FastDenseParams(NamedTuple):
    w16: torch.Tensor                      # (in, out) bf16, grid values
    bias: Optional[torch.Tensor]           # (out,) f32 or None
    act: Optional[ScalarQuantParams]       # input quantizer (per-tensor)
    res: Optional[ScalarQuantParams]       # result requantizer (per-tensor)


def scalar_params(qcfg, qstate) -> ScalarQuantParams:
    """Reduce a per-tensor FP quantizer state to fast-path scalars."""
    if qcfg.method != QMethod.fp_quantizer:
        raise NotImplementedError(f"fast-path scalars of uniform quantizers {_LATER}")
    if qstate["maxval"].shape[0] != 1:
        raise ValueError("the fast path needs per-tensor params")
    bias = quantizers.fp_bias(qcfg, qstate)
    return ScalarQuantParams(
        maxval=qstate["maxval"][0],
        bias=to_int32(bias[0]),
        mant=to_int32(torch.round(qstate["mantissa_bits"][0])),
        sign=to_int32(qstate["sign_bits"][0]),
    )


def _site_state(site):
    return {k: getattr(site, k) for k in site._Q_KEYS}


def finalize_dense(layer, n_bits_w: Optional[int] = None) -> FastDenseParams:
    """Freeze one calibrated ``QuantDense`` into fast-path params."""
    qc: QuantConfig = layer.qc
    wq_cfg = qc.weight_quantizer(n_bits_w)
    wq = quantizers.apply(wq_cfg, _site_state(layer.weight_quantizer), layer.kernel,
                          channel_axis=-1)
    act = None
    if qc.quantize_input:
        act = scalar_params(qc.act_quantizer(), _site_state(layer.activation_quantizer))
    res = None
    if qc.run_method.res_quantizer_flag and layer.res_quantizer is not None:
        res = scalar_params(qc.act_quantizer(), _site_state(layer.res_quantizer))
    return FastDenseParams(w16=wq.detach().to(torch.bfloat16), bias=layer.bias,
                           act=act, res=res)


def quantized_matmul(x, w16, act: Optional[ScalarQuantParams] = None,
                     res: Optional[ScalarQuantParams] = None, bias=None,
                     out_dtype=torch.float32):
    """``requant(quantize(x) @ w16 + bias)``: K2 (x quantized on its load
    when ``act`` is given, f32 sums of bf16 products), the bias, K1 on the
    result.

    x: (..., K) float32 (or bf16 already-quantized when ``act`` is None).
    """
    x2d = x.reshape(-1, x.shape[-1])
    if act is not None:
        x2d = x2d.to(torch.float32)
    out = k2.fused_quant_matmul(x2d, w16, act, quantize_x=act is not None)
    if bias is not None:
        # the bias adds before the res requant, as the layer's plain path does
        out = out + bias
    if res is not None:
        out = k2.quantize_block(out, *res)
    return out.reshape(*x.shape[:-1], w16.shape[-1]).to(out_dtype)


def fast_dense_apply(p: FastDenseParams, x, out_dtype=torch.float32):
    """Apply a finalized dense layer (no activation fn)."""
    return quantized_matmul(x, p.w16, p.act, p.res, p.bias, out_dtype)


def _cached_layers(model):
    """(name, layer) of every layer holding a weight cache."""
    return [(name, m) for name, m in model.named_modules()
            if getattr(m, "w_q", None) is not None]


@torch.no_grad()
def pack_dense_caches(model, qc: QuantConfig, n_bits_w: Optional[int] = None):
    """Install 1-byte packed weight codes on every layer whose weight cache
    (``cache_weights``) holds a quantized kernel of two or more dims:
    ``w_codes`` (uint8 ExMy codes, conv kernels flattened to
    ``(prod(K)*I, O)``) and ``w_pack_bias`` (int32 per-channel packing
    bias), which the ``packed`` apply path decodes. Layers whose format
    does not fit a byte, or whose quantizer state disagrees with the static
    config (an elected mantissa width, an unsigned grid), stay unpacked.

    Updates ``model`` in place and returns ``(model, report)``: ``report``
    maps layer names to the fraction of channels packed bit-exactly (see
    ``pack_weights``).
    """
    from .cuda.dequant_matmul import pack_weights

    wq_cfg = qc.weight_quantizer(n_bits_w)
    if wq_cfg.method != QMethod.fp_quantizer:
        raise NotImplementedError(f"int8/int4 packing of uniform quantizers {_LATER}")
    mant = int(wq_cfg.fp8.mantissa_bits)
    report = {}
    for name, layer in _cached_layers(model):
        w_q, w_bias = layer.w_q, layer.w_bias
        if w_q.ndim < 2 or w_bias is None or w_bias.numel() == 0:
            continue
        n_bits = int(layer.w_nbits[0]) if layer.w_nbits is not None else wq_cfg.n_bits
        expo = n_bits - 1 - mant
        if expo < 1 or 1 + expo + mant > 8:
            continue
        site = layer.weight_quantizer
        if (int(torch.round(site.mantissa_bits[0])) != mant
                or int(site.sign_bits[0]) != 1):
            continue
        pw = pack_weights(w_q.reshape(-1, w_q.shape[-1]), w_bias, expo, mant)
        layer.w_codes = pw.codes
        layer.w_pack_bias = pw.bias
        report[name] = float(pw.exact_fraction)
    return model, report


def strip_packed_params(model):
    """Drop the f32 kernels and bf16 weight caches of packed layers: a
    packed-phase apply never reads them, which cuts resident weight memory
    to the 1-byte codes. The stripped model only works with ``packed``
    phases; re-calibration needs the originals."""
    for _, layer in _cached_layers(model):
        if getattr(layer, "w_codes", None) is None:
            continue
        layer.w_q = None
        layer.w_bias = None
        layer.kernel = None
    return model
