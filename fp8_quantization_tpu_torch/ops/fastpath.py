"""Inference fast path (port of ``ops/fastpath.py``): frozen per-tensor
quantizer scalars, the fused quantized matmul, the integer serving path of
the uniform quantizers, and the packing of cached dense weights.

``finalize_dense`` turns a calibrated FP ``QuantDense`` into fast-path
params: weights pre-quantized onto their ExMy grid as bfloat16 (exact for
mant_width <= 7) and per-tensor act/res quantizers reduced to
``(maxval, bias, mant, sign)`` scalars. ``quantized_matmul`` is the fast
mode's one dense product: the fused quant GEMM (K2), with the bit-ops
quantizer (K1) on x on the load and on the result. ``QuantDense`` runs it
under ``fast``.

Uniform quantizers serve on integer codes: ``pack_dense_caches`` stores a
dense layer's weights as int8 codes (``w_i8*``) or, at 4 bits or fewer, as
nibble pairs (``w_i4*``, :func:`pack_int4`); ``quantize_acts_int8`` turns
the input into int8 codes on the act site's grid; the product sums exactly
in int32 (:func:`int8_matmul`, or the nibble GEMM K5 for ``w_i4``) and
``quantized_matmul_int8`` scales it back. A conv layer whose input a
per-tensor uniform act site quantizes keeps kernel-shaped ``w_i8`` codes
(or flattened ``w_i4`` nibbles) and runs :func:`quantized_conv_int8`, whose
int32 sums come from :func:`int8_conv_sums`; under ``chained`` its result
leaves as a pending ``quant.sites.Affine`` (:func:`quantize_acts_affine`
folds it into the next act site).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

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
    """Reduce a per-tensor FP quantizer state to fast-path scalars. Only the
    FP quantizer has them (the JAX package asserts so)."""
    if qcfg.method != QMethod.fp_quantizer:
        raise ValueError(f"fast-path scalars exist for the fp_quantizer only, not "
                         f"{qcfg.method.value}")
    if qstate["maxval"].shape[0] != 1:
        raise ValueError("the fast path needs per-tensor params")
    bias = quantizers.fp_bias(qcfg, qstate)
    return ScalarQuantParams(
        maxval=qstate["maxval"][0],
        bias=to_int32(bias[0]),
        mant=to_int32(torch.round(qstate["mantissa_bits"][0])),
        sign=to_int32(qstate["sign_bits"][0]),
    )


def finalize_dense(layer, n_bits_w: Optional[int] = None) -> FastDenseParams:
    """Freeze one calibrated ``QuantDense`` into fast-path params."""
    qc: QuantConfig = layer.qc
    wq_cfg = qc.weight_quantizer(n_bits_w)
    wq = quantizers.apply(wq_cfg, layer.weight_quantizer.quant_state(), layer.kernel,
                          channel_axis=-1)
    act = None
    if qc.quantize_input:
        act = scalar_params(qc.act_quantizer(), layer.activation_quantizer.quant_state())
    res = None
    if qc.run_method.res_quantizer_flag and layer.res_quantizer is not None:
        res = scalar_params(qc.act_quantizer(), layer.res_quantizer.quant_state())
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


class Int8Weights(NamedTuple):
    """Frozen uniform-quantized weights as integer codes:
    ``w = scale_n * (i + 128 - zp_n)`` for int8 codes ``i`` (4-bit codes are
    shifted by 8 instead, and ``pack_dense_caches`` stores their ``zp`` in the
    same 128-based coordinates). Symmetric signed weights have no ``zp``."""

    codes: Optional[torch.Tensor]  # (K, N) int8, or None beside nibble-packed codes
    scale: torch.Tensor            # (N,) f32 per channel
    zp: Optional[torch.Tensor]     # (N,) f32 zero point in [0, 255] coordinates, or None
    wsum: torch.Tensor             # (N,) int32: sum_k codes[k, n]


def quantize_acts_int8(x, scale, zero_point, int_min, int_max):
    """Activations straight to int8 codes: ``x_int = clip(round(x / scale) +
    zp, int_min, int_max)`` as ``uniform_apply`` maps them, shifted by -128
    into int8 when the grid is unsigned or asymmetric (``int_min`` 0).
    Returns (codes int8, c_x) with ``x = scale * (codes - c_x)``."""
    x_int = torch.clamp(torch.round(x / scale) + zero_point, int_min, int_max)
    shift = torch.where(int_min < 0, 0.0, 128.0)
    codes = (x_int - shift).to(torch.int8)
    c_x = zero_point - shift
    return codes, c_x


def pack_int4(codes):
    """Nibble-pack (K, N) int8 codes in [-8, 7]: 0.5 byte a weight. Split-K
    halves: byte row i holds code row i in its low nibble and code row
    i + ceil(K/2) in its high nibble (odd K pads one zero code row)."""
    kk = codes.shape[0]
    k2 = -(-kk // 2)
    codes_p = torch.nn.functional.pad(codes, (0, 0, 0, 2 * k2 - kk))
    nib = codes_p.to(torch.int32) & 0xF
    return (nib[:k2] | (nib[k2:] << 4)).to(torch.uint8)


def unpack_int4(packed, k: int):
    """Inverse of :func:`pack_int4`: (ceil(K/2), N) uint8 -> (K, N) int8,
    each nibble sign-extended as ``((p & 0xF) ^ 8) - 8``."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=0)[:k].to(torch.int8)


def int8_matmul(x_codes, w_codes):
    """The exact int32 product of (M, K) and (K, N) int8 codes, the JAX
    package's ``jnp.dot(..., preferred_element_type=int32)``: on the CPU an
    int32 matmul; on the card ``torch._int_mm``, whose operands need more
    than 16 rows and K, N multiples of 8, so the codes are padded with zero
    rows and columns (which add nothing) and the result sliced back. The
    weights go in column-major: cuBLASLt's int8 tensor-core GEMM takes only
    that layout beside row-major x (its "TN" format), and with both
    row-major it finds no kernel at some shapes (K = 16 or 64 at 72 rows)."""
    if x_codes.device.type == "cpu":
        return x_codes.to(torch.int32) @ w_codes.to(torch.int32)
    m, k = x_codes.shape
    n = w_codes.shape[1]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    xp = torch.nn.functional.pad(x_codes, (0, kp - k, 0, mp - m))
    wp = torch.nn.functional.pad(w_codes, (0, np_ - n, 0, kp - k))
    return torch._int_mm(xp, wp.t().contiguous().t())[:m, :n]


def quantized_matmul_int8(x_codes, w: Int8Weights, sx, cx, *, bias=None,
                          out_dtype=torch.float32, w_has_zp: bool = False, acc=None):
    """``(sx * (x - cx)) @ (sw * (w - cw))`` from the exact int32 sum of the
    codes, with the zero points unfolded as rank-1 terms:

      out = sx * sw_n * [dot_mn - cx * Wsum_n - cw_n * Xsum_m + K * cx * cw_n]

    in the JAX package's op order (the int32 sum is exact, so the result is
    too). x_codes: (M, K) int8 from ``quantize_acts_int8``; ``acc``: the int32
    product when the caller has it (K5's, for nibble-packed weights), and
    ``w.codes`` is then unused."""
    k = x_codes.shape[-1]
    if acc is None:
        acc = int8_matmul(x_codes, w.codes)
    out = acc.to(torch.float32) - cx * w.wsum.to(torch.float32)[None, :]
    if w_has_zp:
        cw = w.zp - 128.0
        xsum = torch.sum(x_codes.to(torch.int32), dim=-1, keepdim=True, dtype=torch.int32)
        out = out - cw[None, :] * xsum.to(torch.float32)
        out = out + (k * cx) * cw[None, :]
    out = out * (sx * w.scale)[None, :]
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def quantize_acts_affine(aff, scale, zero_point, int_min, int_max):
    """:func:`quantize_acts_int8` over a pending ``Affine`` input: the
    producer's dequant, BN and clamp fold into this site's quantization
    (``quant.sites.fold_quantize_affine``); the same ``(codes, c_x)``."""
    from ..quant.sites import fold_quantize_affine

    x_int = fold_quantize_affine(aff, scale, zero_point, int_min, int_max)
    shift = torch.where(int_min < 0, 0.0, 128.0)
    return (x_int - shift).to(torch.int8), zero_point - shift


def int8_conv_sums(x_codes, w_codes, cx, *, strides, padding, dilation, groups: int = 1,
                   with_xsum: bool = False, input_dilation=None):
    """The exact int32 sums of a convolution of int8 codes of spatial rank 1,
    2 or 3: x (B, *S, I), w (*K, I/g, O), padding and input-dilation holes
    filled with the zero point's code ``cx`` (so a padded tap is exactly the
    value 0). Returns ``(acc, xsum)``: acc (B, *S_out, O) int32, and with
    ``with_xsum`` each group's window sum of the padded codes (B, *S_out,
    g), the zero-point term of weights with a zero point (else None). The
    JAX package sums in ``lax.conv`` on int8 operands into int32; PyTorch
    has no such convolution on CUDA, so:

    * ungrouped: im2col of the codes (``layers.conv_patches``) times the
      flattened kernel through :func:`int8_matmul` (``torch._int_mm`` on the
      card);
    * grouped and depthwise: an int32 multiply-and-sum over the taps and
      each group's input channels, exact for any kernel.

    Integer sums are exact in any order, so every device gives the same."""
    from .layers import conv_patches, conv_taps

    *ksize, ipg, o = w_codes.shape
    fill = cx.to(torch.int8)
    if groups == 1:
        patches = conv_patches(x_codes, w_codes.shape, strides, padding, dilation, fill,
                               input_dilation)
        lead = patches.shape[:-1]
        acc = int8_matmul(patches.reshape(-1, patches.shape[-1]), w_codes.reshape(-1, o))
        xsum = (torch.sum(patches, dim=-1, keepdim=True, dtype=torch.int32)
                if with_xsum else None)
        return acc.reshape(*lead, o), xsum
    og = o // groups
    taps = conv_taps(x_codes.to(torch.int32), ksize, strides, padding, dilation, fill,
                     input_dilation)
    lead = taps[0].shape[:-1]
    w = w_codes.reshape(len(taps), ipg, groups, og).to(torch.int32)
    acc = torch.zeros((*lead, groups, og), dtype=torch.int32, device=x_codes.device)
    xsum = (torch.zeros((*lead, groups), dtype=torch.int32, device=x_codes.device)
            if with_xsum else None)
    for t, tap in enumerate(taps):
        tap = tap.reshape(*lead, groups, ipg)
        for c in range(ipg):
            acc += tap[..., c, None] * w[t, c]
        if with_xsum:
            xsum += torch.sum(tap, dim=-1, dtype=torch.int32)
    return acc.reshape(*lead, o), xsum


def quantized_conv_int8(x_codes, w_codes, sx, scale, cx, wsum, *, strides, padding,
                        dilation, groups: int = 1, zp=None, bias=None,
                        out_dtype=torch.float32, as_affine: bool = False,
                        input_dilation=None):
    """The int8 convolution of uniform conv serving: the codes' exact int32
    sums (:func:`int8_conv_sums`, padding filled with the ``cx`` code), then
    one f32 epilogue with the zero points unfolded as rank-1 terms:

      out = sx * sw_o * [acc - cx * Wsum_o - cw_o * Xsum + K * cx * cw_o]

    in the JAX package's op order. ``zp`` is the per-output-channel weight
    zero point in [0, 255] coordinates (``cw = zp - 128``), None for signed
    symmetric weights (the Xsum term is then skipped). x_codes (B, H, W, I)
    int8; w_codes (kh, kw, I/g, O) int8; scale (O,) f32; cx () f32,
    integer-valued; wsum (O,) int32. Spatial ranks 1 and 3 work alike (NWC
    or NDHWC codes, a (kw, I/g, O) or (kd, kh, kw, I/g, O) kernel); ``input_dilation`` (a transposed conv) fills its
    holes with ``cx`` as it fills the padding.

    ``as_affine`` (fused-boundary serving): return a pending
    ``quant.sites.Affine`` instead, the epilogue's constants folded into
    per-channel ``scale`` / ``bias`` and only the int32-to-f32 cast (and the
    Xsum term) done on the elements; BN, the clamp and the next act site
    fold on top."""
    acc, xsum = int8_conv_sums(x_codes, w_codes, cx, strides=strides, padding=padding,
                               dilation=dilation, groups=groups, with_xsum=zp is not None,
                               input_dilation=input_dilation)

    def xsum_term():
        o = w_codes.shape[-1]
        cw = zp - 128.0
        xs = torch.repeat_interleave(xsum.to(torch.float32), o // groups, dim=-1) * cw
        return xs, (math.prod(w_codes.shape[:-1]) * cx) * cw

    if as_affine:
        from ..quant.sites import Affine

        x_t = acc.to(torch.float32)
        sc = sx * scale
        b = -(cx * wsum.to(torch.float32)) * sc
        if zp is not None:
            xs, const = xsum_term()
            x_t = x_t - xs
            b = b + const * sc
        if bias is not None:
            b = b + bias
        return Affine(x_t, sc, b)
    out = acc.to(torch.float32) - cx * wsum.to(torch.float32)
    if zp is not None:
        xs, const = xsum_term()
        out = out - xs
        out = out + const
    out = out * (sx * scale)
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def int8_conv_codes(qc: QuantConfig) -> bool:
    """Whether uniform packing gives a conv layer integer codes: its input
    is quantized by a per-tensor uniform act site, whose int8 codes feed
    :func:`quantized_conv_int8`. Other conv layers keep their simulated
    path (and their kernel)."""
    acfg = qc.act_quantizer()
    return (qc.weight_quantizer().method != QMethod.fp_quantizer
            and acfg.method != QMethod.fp_quantizer and not acfg.per_channel
            and qc.quantize_input)


def _cached_layers(model):
    """(name, layer) of every layer holding a weight cache."""
    return [(name, m) for name, m in model.named_modules()
            if getattr(m, "w_q", None) is not None]


@torch.no_grad()
def pack_dense_caches(model, qc: QuantConfig, n_bits_w: Optional[int] = None):
    """Install packed weight codes on every layer whose weight cache
    (``cache_weights``) holds a quantized kernel of two or more dims:

    * FP quantizer: ``w_codes`` (uint8 ExMy codes, conv kernels flattened to
      ``(prod(K)*I, O)``) and ``w_pack_bias`` (int32 per-channel packing
      bias), which the ``packed`` apply path decodes. Layers whose format
      does not fit a byte, or whose quantizer state disagrees with the
      static config (an elected mantissa width, an unsigned grid), stay
      unpacked.
    * uniform quantizers (n_bits <= 8): ``w_i8``, ``w_i8_scale``,
      ``w_i8_sum`` and, where some channel has a nonzero zero point,
      ``w_i8_zp``; at 4 bits or fewer the ``w_i4*`` keys, with the codes
      nibble-packed (:func:`pack_int4`); conv kernels are coded in the
      flattened ``(prod(K)*I, O)`` layout, ``w_i8`` reshaped back to the
      kernel's, and only where :func:`int8_conv_codes` holds.

    Updates ``model`` in place and returns ``(model, report)``: ``report``
    maps layer names to the fraction of channels packed bit-exactly (always
    1.0 for uniform; for FP see ``pack_weights``).
    """
    wq_cfg = qc.weight_quantizer(n_bits_w)
    is_fp = wq_cfg.method == QMethod.fp_quantizer
    report = {}
    for name, layer in _cached_layers(model):
        w_q = layer.w_q
        if w_q.ndim < 2:
            continue
        # the layer's own weight n_bits, recorded at cache time
        n_bits = int(layer.w_nbits[0]) if layer.w_nbits is not None else wq_cfg.n_bits
        if w_q.ndim > 2 and not is_fp and not int8_conv_codes(qc):
            continue  # the conv keeps its simulated path
        pack = _pack_fp if is_fp else _pack_uniform
        exact = pack(layer, wq_cfg, n_bits)
        if exact is not None:
            report[name] = exact
    return model, report


def _pack_fp(layer, wq_cfg, n_bits: int) -> Optional[float]:
    """The FP branch of :func:`pack_dense_caches` for one layer; returns the
    bit-exact channel fraction, or None when the layer stays unpacked."""
    from .cuda.dequant_matmul import pack_weights

    w_q, w_bias = layer.w_q, layer.w_bias
    if w_bias is None or w_bias.numel() == 0:
        return None
    mant = int(wq_cfg.fp8.mantissa_bits)
    expo = n_bits - 1 - mant
    if expo < 1 or 1 + expo + mant > 8:
        return None
    site = layer.weight_quantizer
    if int(torch.round(site.mantissa_bits[0])) != mant or int(site.sign_bits[0]) != 1:
        return None
    pw = pack_weights(w_q.reshape(-1, w_q.shape[-1]), w_bias, expo, mant)
    layer.w_codes = pw.codes
    layer.w_pack_bias = pw.bias
    return float(pw.exact_fraction)


def _pack_uniform(layer, wq_cfg, n_bits: int) -> Optional[float]:
    """The uniform branch of :func:`pack_dense_caches` for one layer (a
    conv kernel in its flattened layout), in the JAX package's arithmetic; returns the fraction of channels whose
    codes give the cached weights back exactly, or None when the layer stays
    unpacked. Every step is per column, so the codes are made a slice of
    columns at a time (``PACK_CHUNK_ELEMENTS``) and a full-width ``lm_head``
    holds no full-size f32 or int32 temporaries."""
    from .cuda.dequant_matmul import PACK_CHUNK_ELEMENTS

    if n_bits > 8:
        return None
    site = layer.weight_quantizer
    w2 = layer.w_q.reshape(-1, layer.w_q.shape[-1])
    k, n = w2.shape
    scale = quantizers.uniform_scale(wq_cfg, site.delta.to(torch.float32)).expand(n).contiguous()
    if wq_cfg.method == QMethod.symmetric_uniform:
        signed = bool(int(site.signed[0]))
        zp_q = torch.zeros((n,), dtype=torch.float32, device=w2.device)
        shift = 0.0 if signed else (8.0 if n_bits <= 4 else 128.0)
    else:
        zp_q = torch.round(site.zero_float.to(torch.float32)).expand(n)
        zp_q = torch.clamp(zp_q, 0.0, 2.0 ** n_bits - 1).contiguous()
        shift = 8.0 if n_bits <= 4 else 128.0
    nibbles = n_bits <= 4
    step = max(1, PACK_CHUNK_ELEMENTS // max(k, 1))
    codes, wsum, exact = [], [], []
    for c in range(0, n, step):
        wc, sc, zc = w2[:, c:c + step], scale[None, c:c + step], zp_q[None, c:c + step]
        cc = (torch.round(wc / sc) + zc - shift).to(torch.int8)
        rt = sc * (cc.to(torch.float32) + shift - zc)
        exact.append(torch.all(rt == wc, dim=0))
        wsum.append(torch.sum(cc, dim=0, dtype=torch.int32))
        codes.append(pack_int4(cc) if nibbles else cc)
    codes, wsum = torch.cat(codes, dim=1), torch.cat(wsum)
    if not nibbles:
        codes = codes.reshape(layer.w_q.shape)  # conv layers keep kernel-shaped codes
    # stored zero point in shifted coordinates, c_w = zp - 128 (0 for signed
    # symmetric), installed only where some channel needs it
    zp_st = zp_q + (128.0 - shift)
    prefix = "w_i4" if nibbles else "w_i8"
    setattr(layer, prefix, codes)
    setattr(layer, prefix + "_scale", scale)
    setattr(layer, prefix + "_sum", wsum)
    if bool(torch.any(zp_st != 128.0)):
        setattr(layer, prefix + "_zp", zp_st)
    # the mean as XLA takes it: the sum times the reciprocal of the count
    return float(torch.cat(exact).to(torch.float32).sum() * (1.0 / n))


def strip_packed_params(model):
    """Drop the f32 kernels and bf16 weight caches of packed layers: a
    packed-phase apply never reads them, which cuts resident weight memory
    to the 1-byte codes. The stripped model only works with ``packed``
    phases; re-calibration needs the originals."""
    for _, layer in _cached_layers(model):
        if all(getattr(layer, key, None) is None for key in ("w_codes", "w_i8", "w_i4")):
            continue
        layer.w_q = None
        layer.w_bias = None
        layer.kernel = None
    return model
