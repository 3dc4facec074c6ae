"""QuantSite: one quantized tensor site as an ``nn.Module`` (port of
``quant/sites.py``).

The JAX package keeps a site's state in the flax ``quant`` / ``quant_est``
collections; here it is the module's buffers, named as the JAX state keys
(``maxval``, ``mantissa_bits``, ``sign_bits`` for the FP quantizer,
``delta``, ``zero_float``, ``signed`` for the uniform ones, and ``xmin``,
``xmax``, ``count``), which ``state_dict`` and ``models.bridge`` address by
the same path. The call carries a phase:

* ``ESTIMATE`` folds the batch into the range estimator, sets the quantizer
  range (updating the buffers in place), then quantizes;
* ``FIXED`` quantizes with the frozen state; the serving phases ``FAST``,
  ``PACKED`` and ``CHAINED`` do so with the bit-ops quantizer kernel (K1)
  on per-tensor FP sites, emit bfloat16 (exact for every ExMy grid with at
  most 7 mantissa bits) and, under ``CHAINED``, 1-byte :class:`CodedFP`
  codes where the site is eligible (:func:`codes_eligible`). Uniform sites
  run ``uniform_apply`` in f32 in every phase (their grids are not
  bf16-exact) and, under ``CHAINED``, emit int8 :class:`Coded` codes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .. import LATER as _LATER
from ..config import EstimatorConfig, QMethod, QuantizerConfig
from ..numerics.rounding import round_ste, to_int32
from . import estimators, quantizers


@dataclasses.dataclass(frozen=True)
class Coded:
    """Activations as int8 codes on a frozen per-tensor uniform grid: the
    chained currency of the uniform quantizers, ``value = scale * (codes -
    cx)``. ``decoded`` gives the fake-quantized values bit for bit: the codes
    and ``cx`` are small integers, exact in f32, and the last multiply is
    the one ``uniform_apply`` ends with."""

    codes: torch.Tensor   # int8
    scale: torch.Tensor   # () f32
    cx: torch.Tensor      # () f32: the zero point in code coordinates

    def reshape(self, *shape):
        """Shape ops act on the codes (the per-tensor scale is unaffected)."""
        return dataclasses.replace(self, codes=self.codes.reshape(*shape))


@dataclasses.dataclass(frozen=True)
class Affine:
    """A tensor with a pending per-channel affine and clamp: the value is
    ``clip(x * scale + bias, lo, hi)`` (no clip where ``lo`` / ``hi`` is
    None), ``scale`` and ``bias`` broadcast on the last axis.

    The fused-boundary currency of CNN serving under ``chained``: between a
    conv's int32 sums and the next layer's act site everything is affine and
    clamp (the dequant epilogue, the inference BN, ReLU / ReLU6), so the
    producer hands the raw tensor and its folded per-channel constants on,
    and the consumer's act site folds them into its own quantization
    (:func:`fold_quantize_affine` on a uniform grid,
    ``quantizers.fp_apply_affine`` on an FP one). The clamp merges into the
    integer bounds exactly; the folded constants equal the sequential chain
    up to f32 rounding of the constants, exactly when scales and stats are
    powers of two."""

    x: torch.Tensor
    scale: torch.Tensor                   # (C,) or () f32
    bias: torch.Tensor                    # (C,) or () f32
    lo: Optional[float] = None            # clamp on the post-affine value
    hi: Optional[float] = None

    @property
    def shape(self):
        return self.x.shape

    @property
    def dtype(self):
        return torch.float32

    def reshape(self, *shape):
        """Leading-dim reshapes only (the constants ride the last axis)."""
        y = self.x.reshape(*shape)
        assert y.shape[-1] == self.x.shape[-1], (y.shape, self.x.shape)
        return dataclasses.replace(self, x=y)

    def then_affine(self, s2, b2):
        """Compose ``v * s2 + b2`` after this affine (no clamp may be set:
        the activation clamp always comes last)."""
        assert self.lo is None and self.hi is None
        return Affine(self.x, self.scale * s2, self.bias * s2 + b2)

    def with_clamp(self, lo, hi):
        assert self.lo is None and self.hi is None
        return dataclasses.replace(self, lo=None if lo is None else float(lo),
                                   hi=None if hi is None else float(hi))


@dataclasses.dataclass(frozen=True)
class CodedFP:
    """Activations as 1-byte ExMy codes on a frozen per-tensor FP grid: the
    FP8 chained serving currency, ``value = unpack_exmy_bits(codes, bias)``.
    Packing uses the site's safe packing bias (``fp_pack_bias``): bit-exact
    with the fake-quantized values when the STE grid fits the byte field,
    else the codes re-quantize onto the ``bias - 1`` grid, moving only
    bottom-binade subnormals by at most half their ULP."""

    codes: torch.Tensor   # uint8 ExMy codes (s:1|e:E|m:M)
    bias: torch.Tensor    # () int32 packing bias
    expo_width: int
    mant_width: int

    def reshape(self, *shape):
        """Shape ops act on the codes (the per-tensor bias is unaffected)."""
        return dataclasses.replace(self, codes=self.codes.reshape(*shape))


def decoded(x, dtype=torch.float32):
    """Materialize a :class:`Coded` (always f32), :class:`CodedFP` or
    :class:`Affine` (always f32) back to values; identity for tensors."""
    if isinstance(x, Coded):
        return x.scale * (x.codes.to(torch.float32) - x.cx)
    if isinstance(x, CodedFP):
        from ..numerics.codec import unpack_consts, unpack_exmy_bits

        eb, ss = unpack_consts(x.bias, x.mant_width)
        return unpack_exmy_bits(x.codes, x.expo_width, x.mant_width, eb, ss, dtype=dtype)
    if isinstance(x, Affine):
        v = x.x.to(torch.float32) * x.scale + x.bias
        if x.lo is not None:
            v = torch.clamp(v, min=x.lo)
        if x.hi is not None:
            v = torch.clamp(v, max=x.hi)
        return v
    return x


def coded_shape(x):
    """Shape of a maybe-coded (or pending-affine) value without decoding it."""
    return x.codes.shape if isinstance(x, (Coded, CodedFP)) else x.shape


@dataclasses.dataclass(frozen=True)
class QuantPhase:
    """Static per-call quantization context.

    ``cache_weights`` fills each layer's weight cache (``w_q``, ``w_bias``,
    ``w_nbits``) so later fixed-phase calls skip the weight quantization;
    ``fast`` runs the bf16 serving mode (sites emit bfloat16, products take
    bf16 operands with f32 sums); ``packed`` has dense layers read 1-byte
    ExMy weight codes (``ops.fastpath.pack_dense_caches``) through the
    dequant GEMM kernel; ``chained`` (on top of ``packed``) passes
    :class:`CodedFP` codes between layers. ``fused_sdpa=True`` sends the
    serving phases' attention through the fused SDPA (K7) and decode
    attention (K6) kernels; ``None`` and ``False`` keep the einsum path, as
    in the JAX package. ``reestimate_bn`` has the BN layers normalize with
    the batch's stats and store them (``eval.driver.reestimate_bn``);
    ``grad_scaling`` raises until its slice lands.
    """

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
        if self.grad_scaling:
            raise NotImplementedError(f"QuantPhase.grad_scaling {_LATER}")

    @property
    def estimating(self) -> bool:
        return self.phase == "estimate"


FP32 = QuantPhase(quant_w=False, quant_a=False)
ESTIMATE = QuantPhase(phase="estimate")
FIXED = QuantPhase(phase="fixed")
FAST = QuantPhase(phase="fixed", fast=True)
PACKED = QuantPhase(phase="fixed", fast=True, packed=True)
CHAINED = QuantPhase(phase="fixed", fast=True, packed=True, chained=True)


def codes_eligible(qcfg: QuantizerConfig, qp: QuantPhase) -> bool:
    """Whether a site may emit :class:`Coded` or :class:`CodedFP` under this
    phase: chained serving with a frozen per-tensor grid; an FP site also
    needs a static byte-sized format (an elected mantissa width,
    ``mse_include_mantissa_bits`` or ``learn_mantissa_bits``, could differ
    from the static split the codes decode with)."""
    if not (qp.chained and not qp.estimating and not qcfg.per_channel):
        return False
    if qcfg.method != QMethod.fp_quantizer:
        return True
    f = qcfg.fp8
    mant = int(f.mantissa_bits)
    expo = qcfg.n_bits - 1 - mant
    return (not f.allow_unsigned and not f.learn_mantissa_bits
            and not f.mse_include_mantissa_bits
            and expo >= 1 and 1 + expo + mant <= 8)


def fold_quantize_affine(aff: Affine, s, zp, lo_i, hi_i):
    """The integer grid codes ``x_int`` of a pending :class:`Affine` value
    on a frozen per-tensor uniform grid, with the affine and clamp folded
    in: ``clip(round(x * (scale / s) + bias / s) + zp, lo', hi')``, one
    mul, one add, one round and one clip an element. It mirrors
    ``clip(round(clip(x * scale + bias, lo, hi) / s) + zp, lo_i, hi_i)``:
    the value clamp merges into the integer bounds because round is
    monotone. ``x * k`` and ``+ c`` round apart in f32, as in the JAX
    package. ``zp`` stays outside the round: ``torch.round`` rounds half to
    even, which does not commute with integer shifts (``round(2.5) = 2`` but
    ``round(2.5 + 13) = 16``)."""
    k = aff.scale / s
    c = aff.bias / s
    t = torch.round(aff.x * k + c) + zp
    lo_b, hi_b = lo_i + 0.0, hi_i + 0.0
    if aff.lo is not None:
        lo_b = torch.maximum(lo_b, torch.round(aff.lo / s) + zp)
    if aff.hi is not None:
        hi_b = torch.minimum(hi_b, torch.round(aff.hi / s) + zp)
    return torch.clamp(t, lo_b, hi_b)


class QuantSite(nn.Module):
    """Quantizer + range estimator for one tensor site.

    ``num_channels`` is the size of ``channel_axis`` for a per-channel site
    (ignored per-tensor): torch buffers need their shape up front, where the
    flax site took it from its first input.
    """

    _EST_KEYS = ("xmin", "xmax", "count")

    def __init__(self, qcfg: QuantizerConfig, ecfg: EstimatorConfig,
                 channel_axis: int = -1, num_channels: int = 1, device=None):
        super().__init__()
        self.qcfg = qcfg
        self.ecfg = ecfg
        self.channel_axis = channel_axis
        c = num_channels if qcfg.per_channel else 1
        q = quantizers.init(qcfg, c, device)
        # the quantizer's state keys: its method's
        self.q_keys = tuple(q)
        for k, v in q.items():
            self.register_buffer(k, v)
        for k, v in estimators.init(ecfg, qcfg, c, device).items():
            self.register_buffer(k, v)
        # (state key, derived values) frozen per state: the bias and K1
        # scalars of an FP site, the integer grid of a uniform one
        self._frozen = None

    def _state(self, keys):
        return {k: getattr(self, k) for k in keys}

    def quant_state(self):
        """The quantizer's state as a dict of this site's buffers."""
        return self._state(self.q_keys)

    def _derived(self, make):
        """``make(state)``, computed once per state and again only after
        the state changes."""
        q = self.quant_state()
        key = tuple((id(t), t._version) for t in q.values())
        if self._frozen is None or self._frozen[0] != key:
            self._frozen = (key, make(q))
        return self._frozen[1]

    def forward(self, x, qp: QuantPhase = FIXED, *, with_bias: bool = False,
                as_codes: bool = False, as_affine: bool = False):
        """Quantize ``x``; returns ``y`` or ``(y, bias)`` when ``with_bias``
        (the approx-matmul path needs the derived exponent bias).

        ``as_codes`` (chained serving): return a :class:`CodedFP`, the
        1-byte codes of the site's frozen grid on its packing bias, or on a
        uniform site a :class:`Coded`, its int8 codes (``quantize_acts_int8``).

        A pending :class:`Affine` input folds into a frozen per-tensor site's
        quantization: on a uniform grid by :func:`fold_quantize_affine`, on an
        FP grid into the quantizer's clip (``quantizers.fp_apply_affine``,
        plain PyTorch: K1 takes no affine). ``as_affine`` (fused CNN
        serving): return the uniform grid codes as an :class:`Affine` with
        the dequant pending (``value = x_int * s - zp * s``), onto which a
        following BN folds."""
        uniform = self.qcfg.method != QMethod.fp_quantizer
        frozen = not (qp.estimating or self.qcfg.per_channel)
        pending = None
        if isinstance(x, Affine):
            if not frozen:
                x = decoded(x)
            elif not uniform:
                pending, x = x, x.x
            else:
                s, zp, lo, hi = self.uniform_int_params()
                x_int = fold_quantize_affine(x, s[0], zp[0], lo[0], hi[0])
                if as_codes:
                    shift = torch.where(lo[0] < 0, 0.0, 128.0)
                    return Coded((x_int - shift).to(torch.int8), s[0], zp[0] - shift)
                if as_affine:
                    return Affine(x_int, s[0], -zp[0] * s[0])
                y = (x_int - zp[0]) * s[0]
                return (y, None) if with_bias else y
        if as_affine:
            if not (frozen and uniform):
                raise ValueError("as_affine needs a frozen per-tensor uniform site")
            s, zp, lo, hi = self.uniform_int_params()
            x_int = torch.clamp(torch.round(decoded(x).to(torch.float32) / s[0]) + zp[0],
                                lo[0], hi[0])
            return Affine(x_int, s[0], -zp[0] * s[0])
        if isinstance(x, (Coded, CodedFP)):
            x = decoded(x)
        if as_codes and uniform:
            if not frozen:
                raise ValueError("as_codes needs a frozen per-tensor site")
            from ..ops.fastpath import quantize_acts_int8

            s, zp, lo, hi = self.uniform_int_params()
            codes, cx = quantize_acts_int8(x.to(torch.float32), s[0], zp[0], lo[0], hi[0])
            return Coded(codes, s[0], cx)
        if as_codes and not codes_eligible(self.qcfg, qp):
            raise ValueError("as_codes on an FP site needs a frozen per-tensor "
                             "byte-sized static format (see codes_eligible)")
        # quantizer math runs in f32; a bf16 input from a fast-mode site
        # holds grid values, so the upcast is lossless
        x = x.to(torch.float32)
        per_channel = self.qcfg.per_channel
        q = self.quant_state()
        if qp.estimating:
            new_est, (x_min, x_max, _) = estimators.update(
                self.ecfg, self.qcfg, self._state(self._EST_KEYS), x.detach(),
                per_channel, self.channel_axis)
            q = quantizers.set_quant_range(self.qcfg, q, x_min, x_max)
            with torch.no_grad():
                for k, v in {**q, **new_est}.items():
                    getattr(self, k).copy_(v)
            q = self.quant_state()
        if uniform:
            # uniform grids are not bf16-exact: f32 values in every phase
            if qp.estimating or per_channel:
                y = quantizers.uniform_apply(self.qcfg, q, x, self.channel_axis)
            else:
                # uniform_apply's arithmetic on the grid derived once per state
                s, zp, lo, hi = self.uniform_int_params()
                y = s * (torch.clamp(round_ste(x / s) + zp, lo, hi) - zp)
            return (y, None) if with_bias else y
        if pending is not None:
            y, bias = quantizers.fp_apply_affine(
                self.qcfg, q, dataclasses.replace(pending, x=x))
        elif qp.fast and not qp.estimating and not per_channel:
            y, bias = self._quantize_block(x, q)
        else:
            y, bias = quantizers.fp_apply(self.qcfg, q, x, self.channel_axis)
        if as_codes:
            from ..numerics.codec import pack_exmy

            mant = int(self.qcfg.fp8.mantissa_bits)
            expo = self.qcfg.n_bits - 1 - mant
            pb = self.fp_pack_bias()[0]
            return CodedFP(codes=pack_exmy(y, expo, mant, pb, clip_of=True), bias=pb,
                           expo_width=expo, mant_width=mant)
        if qp.fast and not qp.estimating and self.qcfg.n_bits <= 8:
            # every ExMy value with mant_width <= 7 is exact in bf16
            y = y.to(torch.bfloat16)
        return (y, bias) if with_bias else y

    def _quantize_block(self, x, q):
        """The frozen per-tensor grid through the bit-ops quantizer kernel
        (K1), the JAX package's ``quantize_block``: equal to
        ``quantizers.fp_apply`` wherever the derived bias is finite. The
        scalars are derived once per state (``fastpath.scalar_params``)."""
        from ..ops.cuda import fused_matmul
        from ..ops.fastpath import scalar_params

        bias, params = self._derived(
            lambda q: (quantizers.fp_bias(self.qcfg, q), scalar_params(self.qcfg, q)))
        return fused_matmul.quantize_block(x, *params), bias

    def fp_bias(self):
        """Derived exponent bias from the current state."""
        if self.qcfg.method != QMethod.fp_quantizer:
            return None
        return quantizers.fp_bias(self.qcfg, self.quant_state())

    def fp_pack_bias(self):
        """Safe int32 bias for 1-byte code packing: the STE bias when
        ``maxval``'s binade fits the E-bit field, else ``bias - 1`` (the
        STE quantizer rounds its bias, which can put the top binade one past
        the field). The binade test is integer arithmetic on the IEEE
        exponent field."""
        q = self.quant_state()
        bias = to_int32(quantizers.fp_bias(self.qcfg, q))
        mant = int(self.qcfg.fp8.mantissa_bits)
        expo = self.qcfg.n_bits - 1 - mant
        mv = q["maxval"].to(torch.float32).contiguous()
        e_ieee = (torch.bitwise_right_shift(mv.view(torch.int32), 23) & 0xFF) - 127
        fits = (e_ieee + bias) <= (1 << expo) - 1
        return torch.where(fits, bias, bias - 1)

    def uniform_int_params(self):
        """(scale, zero_point, int_min, int_max), each of shape (1,), of the
        frozen uniform grid: the scalars of the int8 serving path
        (``fastpath.quantize_acts_int8``). Derived once per state."""
        return self._derived(self._uniform_int_params)

    def _uniform_int_params(self, q):
        scale = quantizers.uniform_scale(self.qcfg, q["delta"])
        if self.qcfg.method == QMethod.symmetric_uniform:
            int_min, int_max = quantizers.sym_int_bounds(self.qcfg, q["signed"])
            zp = torch.zeros_like(scale)
        else:
            int_min = torch.zeros((1,), dtype=torch.float32, device=scale.device)
            int_max = torch.full((1,), 2.0 ** self.qcfg.n_bits - 1, dtype=torch.float32,
                                 device=scale.device)
            zp = torch.clamp(torch.round(q["zero_float"]), int_min, int_max)
        return scale, zp, int_min, int_max
