"""Quantize an arbitrary PyTorch model by interception (port of
``models/flax_surgery.py``; the names stay, so a reader finds the
counterpart, but the model is any ``torch.nn.Module``).

The reference can quantize any torch model by rewriting its module tree
(``quantize_model`` with ``specials`` hooks in its ``autoquant_utils.py``).
The JAX package intercepts the ``nn.Dense`` / ``nn.Conv`` / ``nn.LayerNorm``
calls of a foreign flax model with ``nn.intercept_methods``. Here
:func:`quantize_flax_model` copies the module tree (its modules, not their
tensors) and swaps each handled layer, by default every ``nn.Linear``,
``nn.Conv2d`` and ``nn.LayerNorm``, for an intercepted copy of it, which:

* holds the foreign layer's own parameters (the same tensors under the same
  names: the foreign model's ``state_dict`` keys load unchanged, and a load
  into either model shows in both);
* holds the layer's QuantSites (``activation_quantizer``, ``res_quantizer``,
  ``weight_quantizer``) and its frozen-weight cache (the buffers of
  ``ops.layers.CACHE_KEYS``) under the layer's own name, as the port's
  ``QuantDense`` / ``QuantConv`` / ``QuantLayerNorm`` name them, so one
  layer's site state loads into such a layer;
* runs the reference's hijacker protocol in place of the layer's op:
  input-quant -> weight-quant -> op -> res-quant -> approx/qama rerun ->
  output-quant, through those port layers' own steps (the copy's class
  derives from ``ops.layers._QuantOpBase`` and its foreign class; the steps
  are held to the JAX package's): K3 for the approximate products on a GPU.

The given module keeps its own layers and ``forward``.
:meth:`QuantizedFlaxModel.forward` (``*args, qp=FIXED, **kwargs``) calls the
foreign model's own ``forward`` with the phase set for the length of that
call, as JAX's interceptor closure carries it: the phase lives in a
thread-local slot of the wrapper, restored on the way out (an exception
included), so it reaches no other thread's forward and outlives no call. An
intercepted layer called outside such a call, or where nothing would be
quantized (no quantized input, weight or special run method: the FP32
phase), runs the foreign layer's own op, so that phase equals the foreign
model bit for bit.

Layouts: ``nn.Linear``'s (out, in) weight is quantized and multiplied as its
(in, out) transpose, and ``nn.Conv2d`` runs channels-last on its NCHW input
and OIHW weight (NHWC, HWIO, and back to NCHW), so the per-output-channel
weight site reduces over the elements JAX's ``channel_axis=-1`` does and the
cached ``w_q`` has the port layers' layout. A conv's ``padding`` (ints,
pairs, "same", "valid") becomes explicit (lo, hi) pads; torch has no
asymmetric padding, so flax's "SAME" at stride 2 on an even input, which pads
(0, 1), has no torch twin. A ``padding_mode`` other than "zeros" is refused.
A LayerNorm normalizes its last axis with ``mod.eps`` (torch's default is
1e-5, flax's 1e-6).

Placement note (as in the JAX package): the reference fuses a following
activation into the hijacked layer and quantizes after it. Interception
cannot see the caller's next op, so with ``quantize_input=False`` the output
site quantizes the raw layer output (pre-activation). The canonical configs
(``scripts/image_net.sh``) run ``--quantize-input``, where behaviour is
identical.

``specials`` maps module types to custom handlers ``fn(qc, module, x, qp)``
(the reference's ``specials`` dict), called with the intercepted copy;
``filter_fn(path, module)`` returns False to leave a layer unquantized
(``path`` is the layer's dotted name in the given model's
``named_modules()``; JAX's is the ``/``-joined flax path). JAX's conv
handler is 2-D only; other conv ranks go through ``specials``, as there.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import threading
from typing import Callable, Dict, Optional, Type

import torch
from torch import nn

from ..config import QuantConfig
from ..ops.layers import _QuantOpBase, conv_nd, conv_patches, dilate_and_pad
from ..quant.sites import FIXED, QuantPhase

# ---------------------------------------------------------------------------
# Protocol pieces: the port layers' own, on an intercepted layer
# ---------------------------------------------------------------------------


class _Intercepted(_QuantOpBase):
    """The protocol pieces of ``ops.layers``' quantized layers, given to an
    intercepted foreign layer: its copy's class becomes a subclass of this
    and of its own class (``_INTERCEPTED``), so it keeps its parameters and
    its own ``forward`` and gains the sites, the weight cache (filled by a
    ``cache_weights`` forward or a ``state_dict``) and the hijacker steps.
    As JAX's interceptor, it runs no serving mode and no fused activation."""

    activation = None
    n_bits_w = n_bits_act = None
    quantize_output = True
    serving = False

    def _intercept(self, qc: QuantConfig, channels: Optional[int], res_site: bool = True,
                   cache: bool = True):
        """The sites the JAX interceptor populates under ``ESTIMATE``: the
        per-output-channel weight site where the layer has a weight
        (``channels`` not None); the weight cache where ``cache``."""
        self.qc = qc
        dev = next(self.parameters(), torch.empty(0)).device
        self._make_sites(None, channels, res_site, dev)
        if cache:
            self._init_cache()


class _InterceptedLinear(_Intercepted, nn.Linear):
    pass


class _InterceptedConv2d(_Intercepted, nn.Conv2d):
    pass


class _InterceptedLayerNorm(_Intercepted, nn.LayerNorm):
    pass


def _foreign(mod: nn.Module, x):
    """The foreign layer's own op."""
    return type(mod).forward(mod, x)


def _quantizes(mod: _Intercepted, qp: QuantPhase) -> bool:
    """Whether the protocol differs from the plain op at a dense or conv
    layer: something is quantized, or a special run method reruns the
    product."""
    return qp.quant_a or qp.quant_w or mod._special_armed()


def _product(x, w):
    """``x @ w`` in the operands' promoted dtype (as ``jnp.matmul``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


# ---------------------------------------------------------------------------
# Per-layer handlers
# ---------------------------------------------------------------------------


def _dense_forward(qc: QuantConfig, mod: _InterceptedLinear, x, qp: QuantPhase):
    """Quantized stand-in for ``nn.Linear.forward`` (the ``QuantDense``
    protocol on the (in, out) transpose of the weight)."""
    if not _quantizes(mod, qp):
        return _foreign(mod, x)
    bias = mod.bias
    x, a_bias = mod._quant_in(x, qp)
    w, w_bias = mod._quant_weight(mod.weight.t().contiguous(), qp)

    res = None
    if mod._plain_first(qp):
        res = _product(x, w)
        if bias is not None:
            res = res + bias
        res = mod._res_quant(res, qp)
    if mod._special_armed():
        out2d = mod._special_matmul(x.reshape(-1, x.shape[-1]), w, a_bias, w_bias)
        res = out2d.reshape(*x.shape[:-1], mod.out_features)
        if bias is not None:
            res = res + bias
    return mod._tail(res, qp)


def _conv_pads(mod: nn.Conv2d):
    """torch's ``padding`` as explicit (lo, hi) pairs: "same" pads ``d *
    (k - 1)`` in all, the smaller half first, as torch does."""
    if mod.padding == "valid":
        return tuple((0, 0) for _ in mod.kernel_size)
    if mod.padding == "same":
        totals = [d * (k - 1) for k, d in zip(mod.kernel_size, mod.dilation)]
        return tuple((t // 2, t - t // 2) for t in totals)
    return tuple((p, p) for p in mod.padding)


def _conv_forward(qc: QuantConfig, mod: _InterceptedConv2d, x, qp: QuantPhase):
    """Quantized stand-in for 2-D ``nn.Conv2d.forward`` (the ``QuantConv``
    protocol), channels-last inside: NCHW in and out, HWIO kernel."""
    if not _quantizes(mod, qp):
        return _foreign(mod, x)
    g = mod.groups
    unbatched = x.ndim == 3
    x = (x[None] if unbatched else x).movedim(1, -1)
    kernel = mod.weight.permute(2, 3, 1, 0).contiguous()
    kernel_shape = tuple(kernel.shape)
    in_ch = x.shape[-1]
    bias = mod.bias
    strides, dilation, pads = tuple(mod.stride), tuple(mod.dilation), _conv_pads(mod)

    x, a_bias = mod._quant_in(x, qp)
    w, w_bias = mod._quant_weight(kernel, qp)

    res = None
    if mod._plain_first(qp):
        # f32 operands and sums, as QuantConv's plain product
        res = conv_nd(dilate_and_pad(x.to(torch.float32), pads), w.to(torch.float32),
                      strides, dilation, g)
        if bias is not None:
            res = res + bias
        res = mod._res_quant(res, qp)
    if mod._special_armed():
        if g != 1:
            raise NotImplementedError(
                "approx/qama special paths for grouped foreign convs: use "
                "models/surgery.py or ops.layers.QuantConv directly")
        patches = conv_patches(x.to(torch.float32), kernel_shape, strides, pads, dilation)
        b, oh, ow, _ = patches.shape
        p2d = patches.reshape(b * oh * ow, kernel_shape[0] * kernel_shape[1] * in_ch)
        w2d = w.reshape(-1, mod.out_channels)
        out2d = mod._special_matmul(p2d, w2d, a_bias, w_bias)
        res = out2d.reshape(b, oh, ow, mod.out_channels)
        if bias is not None:
            res = res + bias
    res = mod._tail(res, qp).movedim(-1, 1)
    return res[0] if unbatched else res


def _layernorm_forward(qc: QuantConfig, mod: _InterceptedLayerNorm, x, qp: QuantPhase):
    """Quantized stand-in for ``nn.LayerNorm.forward`` (the
    ``QuantLayerNorm`` protocol: the scale is quantized as the weight). A
    module that declares ``use_fast_variance`` (flax's switch) gets that
    variance; torch's LayerNorm declares none."""
    if not (qp.quant_a or qp.quant_w):
        return _foreign(mod, x)
    x, _ = mod._quant_in(x, qp)
    x = x.to(torch.float32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    if getattr(mod, "use_fast_variance", False):
        var = torch.clamp(torch.mean(torch.square(x), dim=-1, keepdim=True)
                          - torch.square(mean), min=0.0)
    else:
        var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + mod.eps)
    if mod.weight is not None:
        scale = mod.weight
        if qp.quant_w:
            scale = mod.weight_quantizer(scale, qp)
        y = y * scale
    if mod.bias is not None:
        y = y + mod.bias
    return mod._tail(y, qp)


def _setup_dense(qc, mod: _InterceptedLinear):
    mod._intercept(qc, mod.out_features)


def _setup_conv(qc, mod: _InterceptedConv2d):
    if mod.padding_mode != "zeros":
        raise ValueError(f"padding_mode {mod.padding_mode!r}: only 'zeros' is intercepted")
    mod._intercept(qc, mod.out_channels)


def _setup_layernorm(qc, mod: _InterceptedLayerNorm):
    if len(mod.normalized_shape) != 1:
        raise ValueError(f"LayerNorm over {mod.normalized_shape}: the handler normalizes the "
                         "last axis only")
    mod._intercept(qc, mod.normalized_shape[0] if mod.weight is not None else None,
                   res_site=False, cache=False)


_DEFAULT_HANDLERS: Dict[Type[nn.Module], Callable] = {
    nn.Linear: _dense_forward,
    nn.Conv2d: _conv_forward,
    nn.LayerNorm: _layernorm_forward,
}
# a default handler's layer: its class and the state it gets when swapped in
_INTERCEPTED = {_dense_forward: (_InterceptedLinear, _setup_dense),
                _conv_forward: (_InterceptedConv2d, _setup_conv),
                _layernorm_forward: (_InterceptedLayerNorm, _setup_layernorm)}


# ---------------------------------------------------------------------------
# The module swap and the wrapper module
# ---------------------------------------------------------------------------


class _PhaseSlot(threading.local):
    """The phase of the :class:`QuantizedFlaxModel` call running in this
    thread; None outside one."""

    qp: Optional[QuantPhase] = None

    def __reduce__(self):
        return _PhaseSlot, ()


@contextlib.contextmanager
def _phase(slot: _PhaseSlot, qp: QuantPhase):
    saved = slot.qp
    slot.qp = qp
    try:
        yield
    finally:
        slot.qp = saved


def _intercepted_forward(mod, handler, qc, slot: _PhaseSlot, *args, **kwargs):
    qp = slot.qp
    if qp is None:
        return type(mod).forward(mod, *args, **kwargs)
    return handler(qc, mod, args[0], qp)


def _shallow_copy(mod: nn.Module) -> nn.Module:
    """A copy of ``mod`` sharing its tensors, with its own module, parameter,
    buffer and hook tables, so that swapping or registering on the copy
    leaves ``mod`` as it is."""
    new = copy.copy(mod)
    for key, value in vars(mod).items():
        if isinstance(value, (dict, set)):
            new.__dict__[key] = copy.copy(value)
    return new


def _intercepted_tree(model: nn.Module, qc: QuantConfig, handlers, filter_fn, slot):
    """A copy of ``model``'s module tree in which every module whose type has
    a handler (and which ``filter_fn`` keeps) runs it while ``slot`` holds a
    phase. Children of a handled module are copied and intercepted too: JAX's
    interceptor sees the calls a handler makes."""
    memo: Dict[int, nn.Module] = {}

    def clone(mod, path):
        if id(mod) in memo:
            return memo[id(mod)]
        new = memo[id(mod)] = _shallow_copy(mod)
        for name, child in mod._modules.items():
            if child is not None:
                new._modules[name] = clone(child, f"{path}.{name}" if path else name)
        handler = handlers.get(type(mod))
        if handler is not None and (filter_fn is None or filter_fn(path, mod)):
            if handler in _INTERCEPTED:
                cls, setup = _INTERCEPTED[handler]
                new.__class__ = cls
                setup(qc, new)
            new.forward = functools.partial(_intercepted_forward, new, handler, qc, slot)
        return new

    return clone(model, "")


class QuantizedFlaxModel(nn.Module):
    """Quantize an arbitrary PyTorch model by call interception.

    ``filter_fn(path, module) -> bool`` returns False to leave a layer
    unquantized (``path``: its dotted name in ``model.named_modules()``).
    ``specials`` adds or overrides handlers per module type: ``{MyBlock:
    fn(qc, module, x, qp)}``. The intercepted tree is ``self.model``: its
    ``state_dict`` keys are the foreign model's, plus the layers' site state
    and weight caches."""

    def __init__(self, qc: QuantConfig, model: nn.Module,
                 filter_fn: Optional[Callable[[str, nn.Module], bool]] = None,
                 specials: Optional[Dict[Type[nn.Module], Callable]] = None):
        super().__init__()
        self.qc = qc
        handlers = dict(_DEFAULT_HANDLERS)
        if specials:
            handlers.update(specials)
        self._slot = _PhaseSlot()
        self.model = _intercepted_tree(model, qc, handlers, filter_fn, self._slot)

    def forward(self, *args, qp: QuantPhase = FIXED, **kwargs):
        with _phase(self._slot, qp):
            return self.model(*args, **kwargs)


def quantize_flax_model(model: nn.Module, qc: QuantConfig, filter_fn=None,
                        specials=None) -> QuantizedFlaxModel:
    """The reference's ``quantize_model`` for any ``nn.Module``: a
    :class:`QuantizedFlaxModel` over ``model``, which stays as it is."""
    return QuantizedFlaxModel(qc, model, filter_fn=filter_fn, specials=specials)
