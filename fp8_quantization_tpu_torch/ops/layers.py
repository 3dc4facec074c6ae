"""Quantized layers with the reference's forward protocol (port of
``ops/layers.py``: ``QuantDense``, ``QuantConv`` of spatial rank 1, 2 and 3
(grouped and depthwise too; ``QuantConv1d``), ``QuantConvTranspose(1d)``,
``BNQuantConv`` and ``BNQuantDense`` with their unfolded BN,
``QuantLayerNorm`` and ``QuantizedActWrapper``).

Each layer holds up to three QuantSites (``activation_quantizer``,
``res_quantizer``, ``weight_quantizer``) and runs

  input-quant -> weight-quant -> matmul/conv -> res-quant ->
  [approx | quantize-after-mult-and-add rerun] -> fused activation ->
  output-quant

With a special run method armed, the plain product runs first only in the
``ESTIMATE`` phase or under ``original_quantize_res`` (it drives the
res-quantizer's range), and the special product replaces it. The
approximate multiplier goes through the K3 kernel for dense layers and
ungrouped convs, and through the jnp oracle's semantics
(:func:`approx_matmul_oracle`) for grouped and depthwise convs, whose groups
the JAX package ``jax.vmap``s over its oracle, and wherever the flags ask
for what only the oracle simulates (:func:`approx_matmul_2d`).
Quantize-after-mult-and-add (:func:`qama_matmul_2d`) is plain PyTorch on
every device.

A layer creates exactly the sites its flax counterpart populates under
``ESTIMATE``, named alike, so ``models.bridge`` maps the JAX variables onto
this module's ``state_dict`` one to one. Layouts are the JAX package's:
``(in, out)`` dense kernels, ``(*K, I, O)`` conv kernels, NHWC images, and the
weight quantizer's channel axis -1.

Serving phases: a ``cache_weights`` forward stores each dense and conv
layer's quantized kernel in buffers named as the flax ``quant_cache``
collection (``w_q``, ``w_bias``, ``w_nbits``; ``ops.fastpath.
pack_dense_caches`` adds ``w_codes``, ``w_pack_bias`` for the FP quantizer,
the ``w_i8*`` or nibble-packed ``w_i4*`` integer codes for the uniform
ones). Under ``fast`` FP products take bf16 operands with f32 sums (dense
layers through ``ops.fastpath.quantized_matmul``, the K2 kernel); under
``packed`` a dense layer with FP codes runs the K4 dequant GEMM, with 1-byte
``CodedFP`` input under ``chained``, and a conv decodes its codes and
convolves. A dense layer with uniform codes quantizes its input to int8
codes and sums the integer product exactly (the K5 nibble GEMM for
``w_i4``), with ``Coded`` int8 output under ``chained``; a conv with uniform
codes does the same through ``fastpath.quantized_conv_int8``.

The fused boundary (``chained`` on the CNNs): BN leaves a conv as a pending
``quant.sites.Affine`` (an int8 conv's epilogue too), a pure-clamp
activation sets its bounds, and the next layer's act site folds the whole
chain into its own quantization; whatever else meets an ``Affine``
materializes it with ``decoded``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ApproxConfig, EstimatorConfig, QMethod, QuantConfig
from ..numerics.approx_matmul import approx_products
from ..numerics.codec import unpack_exmy
from ..numerics.luts import get_error_table
from ..parallel import shard_kernels as sk
from ..quant.sites import (FIXED, Affine, QuantPhase, QuantSite, codes_eligible, coded_shape,
                           decoded)
from . import fastpath
from .activations import CLAMP_ACTIVATIONS
from .cuda import approx_matmul as k3
from .cuda.dequant_matmul import PackedWeights
from .fastpath import (Int8Weights, quantize_acts_affine, quantize_acts_int8, quantized_matmul,
                       quantized_matmul_int8, unpack_int4)

# the weight cache of a dense or conv layer, named as the flax quant_cache
CACHE_KEYS = ("w_q", "w_bias", "w_nbits", "w_codes", "w_pack_bias",
              "w_i8", "w_i8_scale", "w_i8_zp", "w_i8_sum",
              "w_i4", "w_i4_scale", "w_i4_zp", "w_i4_sum")

Activation = Optional[Callable[[torch.Tensor], torch.Tensor]]


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal of variance ``1/fan_in`` truncated at
    two standard deviations (rescaled so the truncated variance is right)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def default_fp_bias(approx: ApproxConfig, device=None):
    """Fallback when a site has no FP bias."""
    return torch.tensor([float(2 ** (approx.expo_width - 1))], device=device)


def approx_matmul_2d(x2d, w2d, bias_a, bias_b, bias_r, approx: ApproxConfig):
    """(M, K) @ (K, N) through the approximate-multiplier simulation.
    ``bias_b`` is the per-output-channel weight bias vector. Runs the K3
    wrapper on every device (its plain version on the CPU, the kernel on a
    GPU), or :func:`approx_matmul_oracle` where the flags ask for what only
    the oracle simulates: the integer-domain OF/UF adder, the debug and the
    self-check modes (as the JAX package dispatches)."""
    if approx.sim_hw_add_ofuf or approx.debug_mode or approx.self_check_mode:
        return approx_matmul_oracle(x2d, w2d, bias_a, bias_b, bias_r, approx)
    return k3.approx_matmul(
        x2d.to(torch.float32),
        w2d.to(torch.float32),
        bias_a.reshape(()), bias_b.reshape(-1), bias_r.reshape(()),
        expo_width=approx.expo_width,
        mant_width=approx.mant_width,
        with_comp=approx.with_comp,
        dnsmp_factor=approx.dnsmp_factor,
        with_approx=approx.with_approx,
        with_s2nn2s_opt=approx.with_s2nn2s_opt,
        quant_btw_mult_accu=approx.quant_btw_mult_accu,
        golden_clip_of=approx.golden_clip_of,
    )


# products of the (G, rows, K, N) tensor per call of the oracle's golden
ORACLE_CHUNK_ELEMENTS = 1 << 26
# the deepest sum XLA's CPU reduction takes in ascending order
ASCENDING_SUM_MAX_K = 32


def _row_chunks(m: int, per_row: int):
    """Row slices of at most ``ORACLE_CHUNK_ELEMENTS // per_row`` rows."""
    rows = max(1, ORACLE_CHUNK_ELEMENTS // max(1, per_row))
    return [slice(r, r + rows) for r in range(0, m, rows)]


def approx_matmul_oracle(x, w, bias_a, bias_b, bias_r, approx: ApproxConfig):
    """The JAX package's jnp oracle on any device, optionally batched over a
    leading group axis: x ([G,] M, K), w ([G,] K, N), bias_b ([G,] N) or
    scalar; returns ([G,] M, N). Its s2nn2s zero mask is the raw product's
    (``zero_mask="raw"``), and it sums over k in ascending order up to
    ``ASCENDING_SUM_MAX_K`` (every depthwise conv's K is 9), as XLA's CPU
    reduction does, and in PyTorch's order beyond. It simulates every flag,
    the OF/UF adder (``sim_hw_add_ofuf``, ``with_of_opt``, ``with_uf_opt``)
    too. Rows go in chunks of at most ``ORACLE_CHUNK_ELEMENTS`` products
    (each output row depends only on its own row of x)."""
    table = get_error_table(approx.expo_width, approx.mant_width, approx.with_comp,
                            approx.dnsmp_factor)
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    m, k, n = x.shape[-2], x.shape[-1], w.shape[-1]
    out = x.new_empty((*x.shape[:-1], n))
    for rows in _row_chunks(m, math.prod(x.shape[:-2]) * k * n):
        terms = approx_products(
            x[..., rows, :], w, approx.expo_width, approx.mant_width, bias_a,
            bias_b, bias_r, table, with_approx=approx.with_approx,
            with_s2nn2s_opt=approx.with_s2nn2s_opt, golden_clip_of=approx.golden_clip_of,
            quant_btw_mult_accu=approx.quant_btw_mult_accu, zero_mask="raw",
            sim_hw_add_ofuf=approx.sim_hw_add_ofuf, with_of_opt=approx.with_of_opt,
            with_uf_opt=approx.with_uf_opt)
        if k > ASCENDING_SUM_MAX_K:
            out[..., rows, :] = terms.sum(dim=-2)
            continue
        acc = torch.zeros_like(terms[..., 0, :])
        for kk in range(k):
            acc = acc + terms[..., kk, :]
        out[..., rows, :] = acc
    return out


def qama_matmul_2d(x2d, w2d, res_quant: Callable):
    """Quantize-after-mult-and-add: every partial product of ``x2d @ w2d``
    quantized by ``res_quant`` (the res site's frozen FP grid), summed over
    K, and the sum quantized again. Rows go in chunks of at most
    ``ORACLE_CHUNK_ELEMENTS`` products; each row's arithmetic is the
    unchunked one's."""
    m, k = x2d.shape
    n = w2d.shape[-1]
    out = None
    for rows in _row_chunks(m, k * n):
        prod3d = x2d[rows, :, None] * w2d[None, :, :]
        part = res_quant(prod3d).sum(dim=1)
        if out is None:
            out = part.new_empty((m, n))
        out[rows] = part
    return res_quant(out)


class _QuantOpBase(nn.Module):
    """Shared protocol pieces. Subclasses provide the linear op."""

    # True on the BN-fused layers, whose result feeds the unfolded BN at
    # once: they never emit chained codes
    bn_follows = False
    # False where the layer runs no serving mode (``models.flax_surgery``'s
    # intercepted layers): the weight cache then keeps the weights as the
    # sites give them, and no packing format
    serving = True

    def __init__(self, qc: QuantConfig, *, activation: Activation = None,
                 n_bits_w: Optional[int] = None, n_bits_act: Optional[int] = None,
                 quantize_output: bool = True,
                 act_range_override: Optional[EstimatorConfig] = None,
                 weight_channels: Optional[int] = None, res_site: bool = True,
                 device=None):
        super().__init__()
        self.qc = qc
        self.activation = activation
        self.n_bits_w = n_bits_w
        self.n_bits_act = n_bits_act
        self.quantize_output = quantize_output
        self._make_sites(act_range_override, weight_channels, res_site, device)

    def _make_sites(self, act_range_override: Optional[EstimatorConfig],
                    weight_channels: Optional[int], res_site: bool, device):
        """The activation, res and per-output-channel weight sites."""
        qc = self.qc
        act_q = qc.act_quantizer(self.n_bits_act)
        if qc.quantize_input or self.quantize_output:
            self.activation_quantizer = QuantSite(
                act_q, act_range_override or qc.act_range, device=device)
        else:
            self.activation_quantizer = None
        # the res site takes part only when the input is quantized
        if res_site and qc.quantize_input and qc.run_method.res_quantizer_flag:
            self.res_quantizer = QuantSite(act_q, qc.act_range, device=device)
        else:
            self.res_quantizer = None
        if weight_channels is not None:
            self.weight_quantizer = QuantSite(
                qc.weight_quantizer(self.n_bits_w), qc.weight_range, channel_axis=-1,
                num_channels=weight_channels, device=device)
        else:
            self.weight_quantizer = None

    def _init_cache(self):
        for name in CACHE_KEYS:
            self.register_buffer(name, None)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # weight-cache entries (a JAX quant_cache, or a cached or packed
        # state_dict) arrive for buffers this module has not filled yet
        for name in CACHE_KEYS:
            key = prefix + name
            if name in self._buffers and self._buffers[name] is None and key in state_dict:
                self._buffers[name] = state_dict[key].detach().clone().to(self._device())
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _device(self):
        return next(itertools.chain(self.parameters(), self.buffers())).device

    def _quant_in(self, x, qp: QuantPhase):
        a_bias = None
        if self.qc.quantize_input and qp.quant_a:
            x, a_bias = self.activation_quantizer(x, qp, with_bias=True)
        return x, a_bias

    def _defer_affine(self, x, qp: QuantPhase):
        """Keep a pending :class:`Affine` input as it is when this layer's
        input act site will fold it; materialize anything else coded."""
        if isinstance(x, Affine) and self.qc.quantize_input and qp.quant_a:
            return x
        return decoded(x)

    def _quant_weight(self, kernel, qp: QuantPhase):
        if not qp.quant_w:
            return kernel, None
        # bf16 storage is lossless only for FP (ExMy) grids
        fast = qp.fast and self.serving
        fast_bf16 = fast and self.qc.method == QMethod.fp_quantizer
        if qp.cache_weights:
            w, w_bias = self.weight_quantizer(kernel, qp, with_bias=True)
            if fast_bf16:
                w = w.to(torch.bfloat16)
            wb = w_bias if w_bias is not None else torch.zeros(0, device=w.device)
            self.w_q, self.w_bias = w.detach(), wb.detach()
            if self.serving:
                # the layer's own weight n_bits, so packing uses its format
                self.w_nbits = torch.tensor([self.qc.weight_quantizer(self.n_bits_w).n_bits],
                                            dtype=torch.int32, device=w.device)
            return w, w_bias
        if not qp.estimating and self.w_q is not None:
            w, wb = self.w_q, self.w_bias
            if fast_bf16:
                w = w.to(torch.bfloat16)
            elif fast and w.dtype == torch.bfloat16:
                w = w.to(torch.float32)
            return w, (wb if wb.numel() else None)
        return self.weight_quantizer(kernel, qp, with_bias=True)

    def _packed_weights(self, qp: QuantPhase):
        """The 1-byte weight codes installed by ``fastpath.pack_dense_caches``
        for a ``packed`` phase, or None (the layer falls through to its
        normal path)."""
        if not (qp.packed and qp.quant_w and not qp.estimating
                and not self._special_armed() and self.w_codes is not None):
            return None
        wq_cfg = self.qc.weight_quantizer(self.n_bits_w)
        mant = int(wq_cfg.fp8.mantissa_bits)
        return PackedWeights(codes=self.w_codes, bias=self.w_pack_bias,
                             exact_fraction=torch.ones(()),
                             expo_width=wq_cfg.n_bits - 1 - mant, mant_width=mant)

    def _emits_codes(self, qp: QuantPhase) -> bool:
        """Whether this layer's act and res sites pass chained codes under ``qp``."""
        return (codes_eligible(self.qc.act_quantizer(self.n_bits_act), qp)
                and not self.bn_follows)

    def _special_armed(self) -> bool:
        rm = self.qc.run_method
        return rm.res_quantizer_flag and (
            rm.approx_flag or rm.quantize_after_mult_and_add)

    def _plain_first(self, qp: QuantPhase) -> bool:
        rm = self.qc.run_method
        return qp.estimating or rm.original_quantize_res or not self._special_armed()

    def _res_quant(self, res, qp: QuantPhase, as_codes: bool = False):
        if self.res_quantizer is not None and qp.quant_a:
            res = self.res_quantizer(res, qp, as_codes=as_codes)
        return res

    def _special_biases(self, a_bias, w_bias, dev):
        """The approx path's (activation, weight, result) biases; a site
        without an FP bias takes ``default_fp_bias``."""
        if w_bias is None:
            raise ValueError("approx path requires quantized weights")
        approx = self.qc.approx
        a_b = a_bias if a_bias is not None else default_fp_bias(approx, dev)
        r_bias = (self.res_quantizer.fp_bias()
                  if self.res_quantizer is not None else None)
        r_b = r_bias if r_bias is not None else default_fp_bias(approx, dev)
        return a_b.reshape(-1)[0], w_bias, r_b.reshape(-1)[0]

    def _special_matmul(self, x2d, w2d, a_bias, w_bias):
        """The armed special path on a 2-D matmul, in f32 (grid values
        upcast exactly): quantize-after-mult-and-add through the res site's
        frozen grid, or the approximate multiplier (K3, or the oracle)."""
        x2d, w2d = x2d.to(torch.float32), w2d.to(torch.float32)
        if self.qc.run_method.quantize_after_mult_and_add:
            return qama_matmul_2d(x2d, w2d, self._res_fixed)
        return approx_matmul_2d(x2d, w2d, *self._special_biases(a_bias, w_bias, x2d.device),
                                self.qc.approx)

    def _res_fixed(self, t):
        """The res site applied with its frozen state (the qama quantizer)."""
        return self.res_quantizer(t, FIXED)

    def _tail(self, res, qp: QuantPhase):
        if self.activation is not None:
            clamp = CLAMP_ACTIVATIONS.get(self.activation)
            if (isinstance(res, Affine) and clamp is not None
                    and res.lo is None and res.hi is None):
                # fused boundary: a pure clamp sets the pending bounds, which
                # merge exactly into the next act site's clip
                res = res.with_clamp(*clamp)
            else:
                # a bf16 or coded result holds grid values; the activation
                # runs in f32 as in the fixed phase
                res = self.activation(decoded(res).to(torch.float32))
        if not self.qc.quantize_input and qp.quant_a and self.quantize_output:
            res = self.activation_quantizer(res, qp)
        return res


class QuantDense(_QuantOpBase):
    """Quantized fully-connected layer; ``kernel`` is ``(in, out)``."""

    def __init__(self, qc: QuantConfig, in_features: int, features: int, *,
                 use_bias: bool = True, generator=None, device=None, **kw):
        super().__init__(qc, weight_channels=features, device=device, **kw)
        self.features = features
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(in_features, features, device=device), in_features,
            generator))
        self._init_cache()
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x, qp: QuantPhase = FIXED):
        return self._tail(self._dense_body(x, qp), qp)

    def _int8_weights(self, qp: QuantPhase):
        """The integer weight codes installed by ``fastpath.pack_dense_caches``
        for uniform quantizers under a ``packed`` phase, as ``(Int8Weights,
        w4)``: ``w4`` is the nibble-packed ``w_i4`` for K5 (the weights'
        ``codes`` are then None), else None. ``(None, None)`` when the layer
        falls through: the activation codes need a quantized input."""
        if not (qp.packed and qp.quant_w and qp.quant_a and not qp.estimating
                and self.qc.quantize_input and not self._special_armed()):
            return None, None
        if self.w_i4 is not None:
            return Int8Weights(None, self.w_i4_scale, self.w_i4_zp, self.w_i4_sum), self.w_i4
        if self.w_i8 is not None:
            return Int8Weights(self.w_i8, self.w_i8_scale, self.w_i8_zp, self.w_i8_sum), None
        return None, None

    def _dense_body(self, x, qp: QuantPhase):
        iw, w4 = self._int8_weights(qp)
        if iw is not None:
            return self._int8_body(x, iw, w4, qp)
        pw = self._packed_weights(qp)
        if pw is not None:
            return self._packed_body(x, pw, qp)
        x, a_bias = self._quant_in(self._defer_affine(x, qp), qp)
        w, w_bias = self._quant_weight(self.kernel, qp)

        res = None
        if self._plain_first(qp):
            res = dense_product(x, w)
            if self.bias is not None:
                res = res + self.bias
            res = self._res_quant(res, qp, as_codes=self._emits_codes(qp))

        if self._special_armed():
            x2d = x.reshape(-1, x.shape[-1])
            out2d = self._special_matmul(x2d, w, a_bias, w_bias)
            res = out2d.reshape(*x.shape[:-1], self.features)
            if self.bias is not None:
                res = res + self.bias
        return res

    def _packed_body(self, x, pw: PackedWeights, qp: QuantPhase):
        """Real 8-bit serving: the 1-byte weight codes go to the K4 dequant
        GEMM; ``kernel`` is never read, so ``strip_packed_params`` may drop
        it. Under ``chained`` the input is re-quantized on this layer's act
        grid as 1-byte codes, which the kernel decodes on the load."""
        lead_shape = coded_shape(x)[:-1]
        k_in = coded_shape(x)[-1]
        chain_in = self.qc.quantize_input and qp.quant_a and self._emits_codes(qp)
        if chain_in:
            xa = self.activation_quantizer(x, qp, as_codes=True)
            x2d = xa.codes.reshape(-1, k_in)
            xkw = dict(x_bias=xa.bias, x_expo=xa.expo_width, x_mant=xa.mant_width)
        else:
            x, _ = self._quant_in(self._defer_affine(x, qp), qp)
            x2d = x.reshape(-1, k_in).to(torch.bfloat16)
            xkw = {}
        # tensor-parallel under ``parallel.partitioned_kernels(mesh)``: each
        # cell decodes only its (K, N/model) code shard
        out2d = sk.sharded_dequant_matmul(x2d, pw.codes, pw.bias, expo_width=pw.expo_width,
                                          mant_width=pw.mant_width, **xkw)
        res = out2d.reshape(*lead_shape, self.features)
        if self.bias is not None:
            res = res + self.bias
        return self._res_quant(res, qp, as_codes=self._emits_codes(qp))


    def _int8_body(self, x, iw: Int8Weights, w4, qp: QuantPhase):
        """Integer serving of uniform quantizers: the input (a ``Coded``
        from the producer under ``chained``, decoded exactly) becomes int8
        codes on this layer's act grid, their product with the weight codes
        sums exactly in int32 (K5 for nibble-packed ``w4``), and
        ``quantized_matmul_int8`` scales it back; the res site then emits
        values, or ``Coded`` codes under ``chained``. ``kernel`` is never
        read, so ``strip_packed_params`` may drop it."""
        lead_shape = coded_shape(x)[:-1]
        k_in = coded_shape(x)[-1]
        s, zp, lo, hi = self.activation_quantizer.uniform_int_params()
        x2d = decoded(x).reshape(-1, k_in).to(torch.float32)
        codes, cx = quantize_acts_int8(x2d, s[0], zp[0], lo[0], hi[0])
        # tensor-parallel under ``parallel.partitioned_kernels(mesh)``: the
        # nibble codes stay N-sharded per cell
        acc = None if w4 is None else sk.sharded_int4_matmul(codes, w4, k=k_in)
        out2d = quantized_matmul_int8(codes, iw, s[0], cx, w_has_zp=iw.zp is not None,
                                      acc=acc)
        res = out2d.reshape(*lead_shape, self.features)
        if self.bias is not None:
            res = res + self.bias
        return self._res_quant(res, qp, as_codes=self._emits_codes(qp))


def dense_product(x, w):
    """``x @ w`` with f32 sums. bf16 operands (the fast phases' grid values)
    go to the fast path's K2 GEMM; anything else multiplies in f32."""
    if x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        return quantized_matmul(x, w)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def _explicit_padding(spatial, kernel, strides, dilation, padding, input_dilation=None):
    """((lo, hi), ...) per spatial dim for "SAME"/"VALID" or explicit pairs,
    as ``lax.conv_general_dilated`` reads them: string padding is resolved
    on the input-dilated size (``(n - 1) * input_dilation + 1``)."""
    if not isinstance(padding, str):
        return tuple(tuple(int(v) for v in p) for p in padding)
    if padding == "VALID":
        return tuple((0, 0) for _ in spatial)
    if padding != "SAME":
        raise ValueError(f"unsupported padding {padding!r}")
    ld = tuple(input_dilation) if input_dilation is not None else (1,) * len(spatial)
    pads = []
    for n, k, s, d, l in zip(spatial, kernel, strides, dilation, ld):
        n = (n - 1) * l + 1 if n else 0
        eff = d * (k - 1) + 1
        out = -(-n // s)
        total = max((out - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def dilate_and_pad(x, pads, input_dilation=None, fill=None):
    """``x`` (B, *S, C) with ``input_dilation - 1`` holes between neighbours
    of each spatial dim and ``pads`` ((lo, hi) per dim; a negative one
    crops) around it, holes and pads filled with ``fill`` (a 0-dim tensor,
    such as the zero point's int8 code) or zeros: ``lax.pad`` with interior
    padding."""
    spatial = x.shape[1:-1]
    ld = tuple(input_dilation) if input_dilation is not None else (1,) * len(spatial)
    if all(v == 1 for v in ld) and all(lo == 0 and hi == 0 for lo, hi in pads):
        return x
    dil = [(n - 1) * v + 1 if n else 0 for n, v in zip(spatial, ld)]
    shape = (x.shape[0], *(d + max(lo, 0) + max(hi, 0) for d, (lo, hi) in zip(dil, pads)),
             x.shape[-1])
    xp = x.new_zeros(shape) if fill is None else fill.to(x.dtype).expand(shape).clone()
    xp[(slice(None), *(slice(max(lo, 0), max(lo, 0) + d, v)
                       for d, (lo, _), v in zip(dil, pads, ld)))] = x
    return xp[(slice(None), *(slice(max(-lo, 0), size - max(-hi, 0))
                              for size, (lo, hi) in zip(shape[1:-1], pads)))]


def conv_taps(x, kernel_size, strides, padding, dilation, fill=None, input_dilation=None):
    """The ``prod(kernel_size)`` taps of a convolution of any spatial rank
    over a channels-last batch (B, *S, I) of any dtype, in kernel order:
    tap ``t`` is the (B, *S_out, I) strided view of the dilated and padded
    input (:func:`dilate_and_pad`) at each output's window position ``t``."""
    pads = _explicit_padding(x.shape[1:-1], kernel_size, strides, dilation, padding,
                             input_dilation)
    x = dilate_and_pad(x, pads, input_dilation, fill)
    outs = [(n - d * (k - 1) - 1) // s + 1
            for n, k, s, d in zip(x.shape[1:-1], kernel_size, strides, dilation)]
    return [x[(slice(None), *(slice(o * d, o * d + (n - 1) * s + 1, s)
                              for o, d, s, n in zip(offs, dilation, strides, outs)))]
            for offs in itertools.product(*(range(k) for k in kernel_size))]


def conv_patches(x, kernel_shape, strides, padding, dilation, fill=None, input_dilation=None):
    """im2col of a channels-last batch of any dtype: (B, *S_out, prod(K)*I)
    patches whose last dim is ordered (*K, I), matching a (*K, I, O) kernel
    reshaped to ``(prod(K)*I, O)``; padding and input dilation as
    :func:`conv_taps`."""
    taps = conv_taps(x, kernel_shape[:-2], strides, padding, dilation, fill, input_dilation)
    lead, in_ch = taps[0].shape[:-1], taps[0].shape[-1]
    return torch.stack(taps, dim=-2).reshape(*lead, len(taps) * in_ch)


def conv_nd(x, w, strides, dilation, groups: int = 1):
    """The f32 correlation of a channels-last batch (B, *S, I) already
    padded with a (*K, I/g, O) kernel: ``F.conv1d``, ``F.conv2d`` or
    ``F.conv3d``."""
    n = w.ndim - 2
    conv = (F.conv1d, F.conv2d, F.conv3d)[n - 1]
    out = conv(x.movedim(-1, 1), w.permute(n + 1, n, *range(n)), stride=tuple(strides),
               dilation=tuple(dilation), groups=groups)
    return out.movedim(1, -1)


class QuantConv(_QuantOpBase):
    """Quantized convolution of spatial rank 1, 2 or 3: channels-last
    inputs (NWC, NHWC, NDHWC), a ``(*K, I/g, O)`` kernel for ``g =
    feature_group_count`` groups (``g = I`` depthwise), per-channel weight
    quantization along O. The plain product is ``F.conv1d`` / ``F.conv2d`` /
    ``F.conv3d(groups=g)`` in f32 on the padded input; the approx path runs
    the im2col patches through K3 for ``g = 1`` and through :func:`approx_matmul_oracle`, all groups in one
    call, otherwise. Every path reads the correlation from
    :meth:`_conv_plan`, which :class:`QuantConvTranspose` overrides."""

    def __init__(self, qc: QuantConfig, in_features: int, features: int, *,
                 kernel_size: Tuple[int, ...] = (3, 3),
                 strides: Optional[Tuple[int, ...]] = None,
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 kernel_dilation: Optional[Tuple[int, ...]] = None,
                 feature_group_count: int = 1, use_bias: bool = True,
                 generator=None, device=None, **kw):
        n = len(kernel_size)
        if n not in (1, 2, 3):
            # torch has no 4-D convolution for the plain product
            raise ValueError(f"QuantConv of spatial rank {n}: ranks 1 to 3 only")
        g = feature_group_count
        if in_features % g or features % g:
            raise ValueError(f"{g} groups do not divide {in_features} -> {features} channels")
        super().__init__(qc, weight_channels=features, device=device, **kw)
        self._init_cache()
        self.features = features
        self.groups = g
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides) if strides is not None else (1,) * n
        self.dilation = tuple(kernel_dilation) if kernel_dilation is not None else (1,) * n
        self.padding = padding
        shape = (*self.kernel_size, in_features // g, features)
        fan_in = math.prod(shape[:-1])
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(shape, device=device), fan_in, generator))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x, qp: QuantPhase = FIXED):
        return self._tail(self._conv_body(x, qp), qp)

    def _conv_plan(self):
        """(window strides, padding, input dilation) of the correlation
        every path computes."""
        return self.strides, self.padding, None

    def _conv_int8(self, x, qp: QuantPhase):
        """Integer conv serving of uniform quantizers, or None where the
        layer has no integer codes or its act site is not frozen per-tensor
        uniform. The input (a pending :class:`Affine` folded by
        ``quantize_acts_affine``, or values) becomes int8 codes on this
        layer's act grid, and ``fastpath.quantized_conv_int8`` sums them
        exactly against the ``w_i8`` codes (or the unpacked ``w_i4``
        nibbles), padding and input-dilation holes filled with the zero
        point's code. Under ``chained`` the result leaves as an ``Affine``
        (BN and the clamp fold onto it); its res site, where there is one,
        folds it too and stays an ``Affine`` ahead of BN, else emits
        ``Coded``. Returns the pre-BN result."""
        if not (qp.packed and qp.quant_w and qp.quant_a and not qp.estimating
                and self.qc.quantize_input and not self._special_armed()):
            return None
        acfg = self.qc.act_quantizer(self.n_bits_act)
        if acfg.method == QMethod.fp_quantizer or acfg.per_channel:
            return None
        if self.w_i8 is None and self.w_i4 is None:
            return None
        in_ch = coded_shape(x)[-1]
        kernel_shape = (*self.kernel_size, in_ch // self.groups, self.features)
        s, zp, lo, hi = self.activation_quantizer.uniform_int_params()
        if isinstance(x, Affine):
            codes, cx = quantize_acts_affine(x, s[0], zp[0], lo[0], hi[0])
        else:
            codes, cx = quantize_acts_int8(decoded(x).to(torch.float32), s[0], zp[0], lo[0],
                                           hi[0])
        if self.w_i4 is not None:
            w_codes = unpack_int4(self.w_i4, math.prod(kernel_shape[:-1])).reshape(kernel_shape)
            scale, zp_w, wsum = self.w_i4_scale, self.w_i4_zp, self.w_i4_sum
        else:
            w_codes, scale, zp_w, wsum = self.w_i8, self.w_i8_scale, self.w_i8_zp, self.w_i8_sum
        strides, padding, input_dilation = self._conv_plan()
        res = fastpath.quantized_conv_int8(
            codes, w_codes, s[0], scale, cx, wsum, strides=strides, padding=padding,
            dilation=self.dilation, input_dilation=input_dilation, groups=self.groups,
            zp=zp_w, as_affine=qp.chained)
        if self.bias is not None:
            res = (dataclasses.replace(res, bias=res.bias + self.bias)
                   if isinstance(res, Affine) else res + self.bias)
        if self.res_quantizer is not None:
            if isinstance(res, Affine) and self.bn_follows:
                res = self.res_quantizer(res, qp, as_affine=True)
            else:
                as_codes = codes_eligible(acfg, qp) and (isinstance(res, Affine)
                                                         or not self.bn_follows)
                res = self.res_quantizer(res, qp, as_codes=as_codes)
        return res

    def _conv_body(self, x, qp: QuantPhase):
        res = self._conv_int8(x, qp)
        if res is not None:
            return res
        # a pending Affine stays pending where the act site folds it
        x = self._defer_affine(x, qp)
        g = self.groups
        in_ch = coded_shape(x)[-1]
        kernel_shape = (*self.kernel_size, in_ch // g, self.features)
        strides, padding, input_dilation = self._conv_plan()
        pw = self._packed_weights(qp)
        x, a_bias = self._quant_in(x, qp)
        if pw is not None:
            # real 8-bit conv serving: the 1-byte kernel codes decode by
            # bit-ops; the f32 kernel is never read
            w = unpack_exmy(pw.codes, pw.expo_width, pw.mant_width, pw.bias[None, :],
                            dtype=torch.bfloat16 if qp.fast else torch.float32
                            ).reshape(kernel_shape)
            w_bias = None
        else:
            w, w_bias = self._quant_weight(self.kernel, qp)

        res = None
        if self._plain_first(qp):
            # f32 operands and sums (bf16 grid values upcast exactly)
            xf = x.to(torch.float32)
            pads = _explicit_padding(xf.shape[1:-1], self.kernel_size, strides,
                                     self.dilation, padding, input_dilation)
            res = conv_nd(dilate_and_pad(xf, pads, input_dilation), w.to(torch.float32),
                          strides, self.dilation, g)
            if self.bias is not None:
                res = res + self.bias
            res = self._res_quant(res, qp)

        if self._special_armed():
            patches = conv_patches(x.to(torch.float32), (*self.kernel_size, in_ch, self.features),
                                   strides, padding, self.dilation, input_dilation=input_dilation)
            lead = patches.shape[:-1]
            m = math.prod(lead)
            k_elems = math.prod(self.kernel_size)
            ipg, og = in_ch // g, self.features // g
            # the patches' last dim is ordered (*K, I), and I splits into
            # (G, I/g); the kernel's O into (G, O/g)
            pg = patches.reshape(m, k_elems, g, ipg).permute(2, 0, 1, 3).reshape(g, m, -1)
            wg = w.to(torch.float32).reshape(k_elems, ipg, g, og).permute(2, 0, 1, 3)
            wg = wg.reshape(g, k_elems * ipg, og)
            if w_bias is not None:
                # a per-tensor weight bias serves every channel
                w_bias = (w_bias.reshape(1, 1).expand(g, og) if w_bias.numel() == 1
                          else w_bias.reshape(g, og))
            if g == 1:
                out_g = self._special_matmul(pg[0], wg[0], a_bias,
                                             None if w_bias is None else w_bias[0])[None]
            elif self.qc.run_method.quantize_after_mult_and_add:
                out_g = torch.stack([qama_matmul_2d(pg[i], wg[i], self._res_fixed)
                                     for i in range(g)])
            else:
                # the JAX package vmaps its jnp oracle over the groups
                out_g = approx_matmul_oracle(
                    pg, wg, *self._special_biases(a_bias, w_bias, pg.device), self.qc.approx)
            res = out_g.permute(1, 0, 2).reshape(*lead, self.features)
            if self.bias is not None:
                res = res + self.bias
        return res


class QuantConv1d(QuantConv):
    """Quantized 1-D convolution: NWC inputs, a ``(KW, I/g, O)`` kernel;
    everything else as :class:`QuantConv`."""

    def __init__(self, qc: QuantConfig, in_features: int, features: int, *,
                 kernel_size: Tuple[int] = (3,), **kw):
        super().__init__(qc, in_features, features, kernel_size=kernel_size, **kw)


def conv_transpose_padding(k: int, s: int, d: int, padding: str):
    """Per-dim explicit (lo, hi) padding that makes an input-dilated
    correlation equal ``lax.conv_transpose`` with string padding (XLA's
    ``_conv_transpose_padding``; ``d`` is the kernel dilation)."""
    k = d * (k - 1) + 1  # the effective kernel size
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"unsupported transpose padding {padding!r}")
    return (pad_a, pad_len - pad_a)


class QuantConvTranspose(QuantConv):
    """Quantized transposed convolution of spatial rank 1, 2 or 3, computed as
    the input-dilated correlation it lowers to (unit window strides, input
    dilation equal to ``strides``, the pads of :func:`conv_transpose_padding`),
    so every path of :class:`QuantConv` serves it: plain, approx, quantize-
    after-mult-and-add, fast, packed, chained and int8 (holes filled with
    the zero point's code). The ``(*K, I, O)`` kernel is applied un-flipped
    (flax's ``ConvTranspose``); ``models.porting.conv_transpose_kernel``
    flips torch's. ``padding`` is "SAME"/"VALID" or explicit (lo, hi) pairs
    on the dilated correlation (torch's ``padding``/``output_padding`` map to
    ``(d*(k-1)-p, d*(k-1)-p+op)``)."""

    def _conv_plan(self):
        if isinstance(self.padding, str):
            pads = tuple(conv_transpose_padding(k, s, d, self.padding)
                         for k, s, d in zip(self.kernel_size, self.strides, self.dilation))
        else:
            pads = tuple(tuple(p) for p in self.padding)
        return (1,) * len(self.kernel_size), pads, self.strides


class QuantConvTranspose1d(QuantConvTranspose):
    """1-D transposed convolution: NWC inputs, a ``(KW, I, O)`` kernel."""

    def __init__(self, qc: QuantConfig, in_features: int, features: int, *,
                 kernel_size: Tuple[int] = (3,), **kw):
        super().__init__(qc, in_features, features, kernel_size=kernel_size, **kw)


def _init_bn(module, features: int, epsilon: float, device):
    """The unfolded BN's state: ``gamma`` / ``beta`` and the f32 running
    ``mean`` / ``var`` buffers (the flax ``batch_stats`` collection)."""
    module.bn_epsilon = epsilon
    module.gamma = nn.Parameter(torch.ones(features, device=device))
    module.beta = nn.Parameter(torch.zeros(features, device=device))
    module.register_buffer("mean", torch.zeros(features, device=device))
    module.register_buffer("var", torch.ones(features, device=device))


class BNQuantConv(QuantConv):
    """Quantized conv + *unfolded* batch norm: f32 running stats (``mean``,
    ``var`` buffers, the flax ``batch_stats`` collection) and ``gamma`` /
    ``beta`` applied after the quantized conv result (and any res-quant or
    approx rerun), before the fused activation. ``QuantPhase.reestimate_bn``
    normalizes with the batch's own stats and stores them (the re-estimation
    pass of ``eval.driver.reestimate_bn`` averages them over batches)."""

    bn_follows = True

    def __init__(self, qc: QuantConfig, in_features: int, features: int, *,
                 bn_epsilon: float = 1e-5, device=None, **kw):
        super().__init__(qc, in_features, features, device=device, **kw)
        _init_bn(self, features, bn_epsilon, device)

    def forward(self, x, qp: QuantPhase = FIXED):
        res = _unfolded_bn(self, self._conv_body(x, qp), qp, self.bn_epsilon)
        return self._tail(res, qp)


class BNQuantDense(QuantDense):
    """Quantized linear + unfolded batch norm (BatchNorm1d's f32 stats),
    applied after the quantized product (and any res-quant or approx rerun),
    before the fused activation, as :class:`BNQuantConv` does."""

    bn_follows = True

    def __init__(self, qc: QuantConfig, in_features: int, features: int, *,
                 bn_epsilon: float = 1e-5, device=None, **kw):
        super().__init__(qc, in_features, features, device=device, **kw)
        _init_bn(self, features, bn_epsilon, device)

    def forward(self, x, qp: QuantPhase = FIXED):
        res = _unfolded_bn(self, self._dense_body(x, qp), qp, self.bn_epsilon)
        return self._tail(res, qp)


def _unfolded_bn(module, res, qp: QuantPhase, epsilon: float):
    """Unfolded f32 BN over all axes but the channel's. Under
    ``reestimate_bn`` it normalizes with the batch's (biased) stats and
    stores their mean and unbiased variance in the running buffers
    (momentum-1 train-mode BN). Under ``chained`` (or on a pending
    :class:`Affine`) inference BN is a per-channel affine: it folds onto the
    pending one, or leaves the result as a new ``Affine``, with no pass over
    the elements (equal to the unfolded BN up to f32 rounding of the folded
    constants)."""
    if not qp.reestimate_bn and (isinstance(res, Affine) or qp.chained):
        rg = torch.rsqrt(module.var + epsilon) * module.gamma
        rb = module.beta - module.mean * rg
        if isinstance(res, Affine):
            return res.then_affine(rg, rb)
        return Affine(decoded(res), rg, rb)
    res = decoded(res).to(torch.float32)
    if qp.reestimate_bn:
        dims = tuple(range(res.ndim - 1))
        mean = torch.mean(res, dim=dims)
        var = torch.var(res, dim=dims, unbiased=False)
        n = math.prod(res.shape[:-1])
        module.mean.copy_(mean)
        module.var.copy_(var * (n / max(n - 1, 1)))
    else:
        mean, var = module.mean, module.var
    return (res - mean) * torch.rsqrt(var + epsilon) * module.gamma + module.beta


class QuantLayerNorm(_QuantOpBase):
    """Quantized LayerNorm: gamma (``scale``) is quantized as the "weight",
    the output as the activation."""

    def __init__(self, qc: QuantConfig, features: int, *, epsilon: float = 1e-6,
                 use_bias: bool = True, use_scale: bool = True, device=None, **kw):
        super().__init__(qc, weight_channels=features if use_scale else None,
                         res_site=False, device=device, **kw)
        self.epsilon = epsilon
        self.scale = (nn.Parameter(torch.ones(features, device=device))
                      if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x, qp: QuantPhase = FIXED):
        x, _ = self._quant_in(decoded(x), qp)
        x = x.to(torch.float32)
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        if self.scale is not None:
            scale = self.scale
            if qp.quant_w:
                scale = self.weight_quantizer(scale, qp)
            y = y * scale
        if self.bias is not None:
            y = y + self.bias
        return self._tail(y, qp)


class QuantizedActWrapper(nn.Module):
    """A parameter-free op (an average pool, ...) with activation
    quantization of its output; with ``tie_input_output`` the same site
    quantizes its input first (the reference's tied activation quantizers),
    folding a pending ``Affine`` or decoding codes as any act site does."""

    def __init__(self, qc: QuantConfig, op: Callable = lambda x: x, *,
                 tie_input_output: bool = False, device=None):
        super().__init__()
        self.qc = qc
        self.op = op
        self.tie_input_output = tie_input_output
        self.activation_quantizer = QuantSite(qc.act_quantizer(), qc.act_range, device=device)

    def forward(self, x, qp: QuantPhase = FIXED):
        if self.tie_input_output and qp.quant_a:
            x = self.activation_quantizer(x, qp)
        else:
            x = decoded(x)
        y = self.op(x)
        if qp.quant_a:
            y = self.activation_quantizer(y, qp)
        return y
