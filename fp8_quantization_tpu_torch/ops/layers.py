"""Quantized layers with the reference's forward protocol (port of
``ops/layers.py``: ``QuantDense``, ungrouped 2-D ``QuantConv`` and
``QuantLayerNorm``).

Each layer holds up to three QuantSites (``activation_quantizer``,
``res_quantizer``, ``weight_quantizer``) and runs

  input-quant -> weight-quant -> matmul/conv -> res-quant ->
  [approx rerun] -> fused activation -> output-quant

With the approx run method armed, the plain product runs first only in the
``ESTIMATE`` phase or under ``original_quantize_res`` (it drives the
res-quantizer's range), and the approximate product replaces it.

A layer creates exactly the sites its flax counterpart populates under
``ESTIMATE``, named alike, so ``models.bridge`` maps the JAX variables onto
this module's ``state_dict`` one to one. Layouts are the JAX package's:
``(in, out)`` dense kernels, ``(*K, I, O)`` conv kernels, NHWC images, and the
weight quantizer's channel axis -1.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import LATER as _LATER
from ..config import ApproxConfig, EstimatorConfig, QuantConfig
from ..quant.sites import FIXED, QuantPhase, QuantSite
from .cuda import approx_matmul as k3

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
    wrapper on every device: its plain version on the CPU, the kernel on a
    GPU."""
    if approx.sim_hw_add_ofuf or approx.debug_mode or approx.self_check_mode:
        raise NotImplementedError(
            f"sim_hw_add_ofuf / debug_mode / self_check_mode {_LATER}")
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


class _QuantOpBase(nn.Module):
    """Shared protocol pieces. Subclasses provide the linear op."""

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
        act_q = qc.act_quantizer(n_bits_act)
        if qc.quantize_input or quantize_output:
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
                qc.weight_quantizer(n_bits_w), qc.weight_range, channel_axis=-1,
                num_channels=weight_channels, device=device)
        else:
            self.weight_quantizer = None

    def _quant_in(self, x, qp: QuantPhase):
        a_bias = None
        if self.qc.quantize_input and qp.quant_a:
            x, a_bias = self.activation_quantizer(x, qp, with_bias=True)
        return x, a_bias

    def _quant_weight(self, kernel, qp: QuantPhase):
        if not qp.quant_w:
            return kernel, None
        return self.weight_quantizer(kernel, qp, with_bias=True)

    def _special_armed(self) -> bool:
        rm = self.qc.run_method
        return rm.res_quantizer_flag and (
            rm.approx_flag or rm.quantize_after_mult_and_add)

    def _plain_first(self, qp: QuantPhase) -> bool:
        rm = self.qc.run_method
        return qp.estimating or rm.original_quantize_res or not self._special_armed()

    def _res_quant(self, res, qp: QuantPhase):
        if self.res_quantizer is not None and qp.quant_a:
            res = self.res_quantizer(res, qp)
        return res

    def _special_matmul(self, x2d, w2d, a_bias, w_bias):
        """The armed special path on a 2-D matmul."""
        if self.qc.run_method.quantize_after_mult_and_add:
            raise NotImplementedError(f"quantize_after_mult_and_add {_LATER}")
        approx = self.qc.approx
        dev = x2d.device
        a_b = a_bias if a_bias is not None else default_fp_bias(approx, dev)
        r_bias = (self.res_quantizer.fp_bias()
                  if self.res_quantizer is not None else None)
        r_b = r_bias if r_bias is not None else default_fp_bias(approx, dev)
        if w_bias is None:
            raise ValueError("approx path requires quantized weights")
        return approx_matmul_2d(x2d, w2d, a_b.reshape(-1)[0], w_bias,
                                r_b.reshape(-1)[0], approx)

    def _tail(self, res, qp: QuantPhase):
        if self.activation is not None:
            res = self.activation(res.to(torch.float32))
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
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x, qp: QuantPhase = FIXED):
        return self._tail(self._dense_body(x, qp), qp)

    def _dense_body(self, x, qp: QuantPhase):
        x, a_bias = self._quant_in(x, qp)
        w, w_bias = self._quant_weight(self.kernel, qp)

        res = None
        if self._plain_first(qp):
            res = torch.matmul(x, w)
            if self.bias is not None:
                res = res + self.bias
            res = self._res_quant(res, qp)

        if self._special_armed():
            x2d = x.reshape(-1, x.shape[-1])
            out2d = self._special_matmul(x2d, w, a_bias, w_bias)
            res = out2d.reshape(*x.shape[:-1], self.features)
            if self.bias is not None:
                res = res + self.bias
        return res


def _explicit_padding(spatial, kernel, strides, dilation, padding):
    """((lo, hi), ...) per spatial dim for "SAME"/"VALID" or explicit pairs,
    as ``lax.conv_general_dilated`` reads them."""
    if not isinstance(padding, str):
        return tuple(tuple(int(v) for v in p) for p in padding)
    if padding == "VALID":
        return tuple((0, 0) for _ in spatial)
    if padding != "SAME":
        raise ValueError(f"unsupported padding {padding!r}")
    pads = []
    for n, k, s, d in zip(spatial, kernel, strides, dilation):
        eff = d * (k - 1) + 1
        out = -(-n // s)
        total = max((out - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _pad_nchw(x, pads):
    """F.pad takes the last dimension first."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat)


def conv_patches(x, kernel_shape, strides, padding, dilation):
    """im2col of an NHWC batch: (B, Ho, Wo, kh*kw*I) patches whose last dim
    is ordered (*K, I), matching a (*K, I, O) kernel reshaped to
    ``(prod(K)*I, O)``."""
    kh, kw, in_ch, _ = kernel_shape
    pads = _explicit_padding(x.shape[1:3], (kh, kw), strides, dilation, padding)
    xp = _pad_nchw(x.permute(0, 3, 1, 2), pads)
    cols = F.unfold(xp, (kh, kw), dilation=dilation, stride=strides)  # (B, I*kh*kw, L)
    b, _, length = cols.shape
    ho = (xp.shape[2] - dilation[0] * (kh - 1) - 1) // strides[0] + 1
    wo = (xp.shape[3] - dilation[1] * (kw - 1) - 1) // strides[1] + 1
    cols = cols.reshape(b, in_ch, kh * kw, length).permute(0, 3, 2, 1)
    return cols.reshape(b, ho, wo, kh * kw * in_ch)


class QuantConv(_QuantOpBase):
    """Quantized 2-D convolution: NHWC inputs, ``(kh, kw, I, O)`` kernel,
    per-channel weight quantization along O. Grouped and depthwise convs
    belong to a later slice."""

    def __init__(self, qc: QuantConfig, in_features: int, features: int, *,
                 kernel_size: Tuple[int, int] = (3, 3),
                 strides: Optional[Tuple[int, int]] = None,
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 kernel_dilation: Optional[Tuple[int, int]] = None,
                 feature_group_count: int = 1, use_bias: bool = True,
                 generator=None, device=None, **kw):
        if feature_group_count != 1:
            raise NotImplementedError(f"grouped / depthwise QuantConv {_LATER}")
        if len(kernel_size) != 2:
            raise NotImplementedError(f"QuantConv of spatial rank {len(kernel_size)} {_LATER}")
        super().__init__(qc, weight_channels=features, device=device, **kw)
        self.features = features
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides) if strides is not None else (1, 1)
        self.dilation = tuple(kernel_dilation) if kernel_dilation is not None else (1, 1)
        self.padding = padding
        shape = (*self.kernel_size, in_features, features)
        fan_in = math.prod(shape[:-1])
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(shape, device=device), fan_in, generator))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x, qp: QuantPhase = FIXED):
        return self._tail(self._conv_body(x, qp), qp)

    def _conv_body(self, x, qp: QuantPhase):
        x, a_bias = self._quant_in(x, qp)
        w, w_bias = self._quant_weight(self.kernel, qp)

        res = None
        if self._plain_first(qp):
            pads = _explicit_padding(x.shape[1:3], self.kernel_size, self.strides,
                                     self.dilation, self.padding)
            res = F.conv2d(_pad_nchw(x.permute(0, 3, 1, 2), pads),
                           w.permute(3, 2, 0, 1), stride=self.strides,
                           dilation=self.dilation).permute(0, 2, 3, 1)
            if self.bias is not None:
                res = res + self.bias
            res = self._res_quant(res, qp)

        if self._special_armed():
            patches = conv_patches(x.to(torch.float32), tuple(w.shape), self.strides,
                                   self.padding, self.dilation)
            lead = patches.shape[:-1]
            out2d = self._special_matmul(
                patches.reshape(-1, patches.shape[-1]),
                w.reshape(-1, self.features),
                a_bias,
                None if w_bias is None else w_bias.reshape(-1))
            res = out2d.reshape(*lead, self.features)
            if self.bias is not None:
                res = res + self.bias
        return res


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
        x, _ = self._quant_in(x, qp)
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
