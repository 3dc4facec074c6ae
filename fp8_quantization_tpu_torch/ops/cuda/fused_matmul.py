"""The bit-ops ExMy quantizer (K1) and the fused quantize -> matmul ->
requantize GEMM (K2): wrappers of the CUDA kernels in
``csrc/fused_matmul.cu`` and their plain PyTorch versions.

Replace ``fp8_quantization_tpu/ops/pallas/fused_matmul.py::quantize_block``
and ``::fused_quant_matmul`` and take the same arguments. A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.

The GEMMs (here and in ``dequant_matmul``) multiply bf16 operands, so every
product is exact in f32; the plain version sums them in f32 in ascending k
(:func:`sequential_matmul`). Each kernel call is one launch, whose route
depends on M alone (:func:`gemm_route`, ``csrc/tile_gemm.cuh``):

- route A, M <= ``ROUTE_A_MAX_M`` (decode): one f32 chain per output in
  ascending k, as the plain version sums, so the two are equal bit for bit;
- route B, larger M (ViT, prefill): tensor-core tiles, which sum in their own
  order: before any requant ``|kernel - plain| <= K * 2^-24 * sum_k |x_k
  w_k|`` per element, and after the requant epilogue each output equals the
  plain one or is exactly one step of the result grid away, where the plain
  sum lies within that tolerance of a rounding midpoint, with at least 99%
  equal (:func:`within_requant_step`, the JAX package's own contract at
  ``tests/test_fused_matmul.py:88-93``).

Against the JAX package, whose XLA dot sums in another order, the plain
versions agree to ``K * 2^-24 * sum_k |x_k w_k|`` per element.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ...numerics.codec import f32_bits
from ...numerics.rounding import to_int32
from . import build

QScalars = Tuple  # (maxval, bias, mant, sign): tensors or numbers


def quantize_block_plain(x, maxval, bias_i, mant_i, sign_i):
    """Elementwise ExMy fake-quantize by exponent bit-ops (K1's plain
    version; per-tensor scalars):

      xc = clip(x, sign ? -maxval : 0, maxval)
      log_scales = max(ieee_exp(xc) - 127 + bias, 1)
      sexp = clip(log_scales - mant - bias + 127, 1, 254)
      q = round_half_even(xc * 2^(127 - sexp)) * 2^(sexp - 127)

    Integer arithmetic wraps in int32, as XLA's does.
    """
    x = torch.as_tensor(x).to(torch.float32)
    dev = x.device
    maxval = torch.as_tensor(maxval, dtype=torch.float32, device=dev).reshape(())
    bias_i = to_int32(bias_i, dev).reshape(())
    mant_i = to_int32(mant_i, dev).reshape(())
    sign_i = to_int32(sign_i, dev).reshape(())
    minval = torch.where(sign_i == 1, -maxval, torch.zeros_like(maxval))
    xc = torch.minimum(torch.maximum(x, minval), maxval)
    e = torch.bitwise_right_shift(xc.contiguous().view(torch.int32), 23) & 0xFF
    log_scales = torch.clamp(e - 127 + bias_i, min=1)
    sexp = torch.clamp(log_scales - mant_i - bias_i + 127, 1, 254)
    scales = f32_bits(torch.bitwise_left_shift(sexp, 23))
    inv_scales = f32_bits(torch.bitwise_left_shift(254 - sexp, 23))
    return torch.round(xc * inv_scales) * scales


def sequential_matmul(a, b):
    """``a @ b`` of f32 tensors summed in f32 in ascending k, one
    ``acc + a[:, k] * b[k]`` at a time: the order the GEMM kernels use. For
    bf16-valued operands each product is exact, so whether the multiply and
    add are fused does not change the result."""
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for kk in range(k):
        acc.addcmul_(a[:, kk:kk + 1], b[kk:kk + 1, :])
    return acc


def _zero_scalars():
    return 0.0, 0, 0, 0


# the largest M that takes route A; both GEMM wrappers pass it to their C
# entry, which routes by it (and refuses more rows than route A holds)
ROUTE_A_MAX_M = 16
# the least fraction of route B's requantized outputs that must equal the
# plain ones (the JAX package's tests/test_fused_matmul.py:88-93)
MIN_EQUAL_FRACTION = 0.99


def gemm_route(m: int) -> str:
    """The route K2 and K4 take for an (M, K) x: ``"A"`` (bit-exact
    streaming) for M <= ``ROUTE_A_MAX_M``, else ``"B"`` (tensor cores)."""
    if m < 0:
        raise ValueError(f"M must be >= 0, got {m}")
    return "A" if m <= ROUTE_A_MAX_M else "B"


def within_requant_step(ours, plain_sum, tol, res_params: Optional[QScalars] = None):
    """Route B's numerics contract, element by element. ``plain_sum`` is the
    plain version's f32 sum (no requant, f32 out), ``tol`` its tolerance
    ``K * 2^-24 * sum_k |x_k w_k|`` (:func:`sum_tolerance`), ``res_params``
    the requant scalars when the epilogue ran.

    Every output must be what the output map R (the requant when
    ``res_params`` is given, then the cast to ``ours.dtype``) gives for some
    sum within ``tol`` of the plain one: it lies in ``[R(s - tol), R(s +
    tol)]``: without the requant and in f32 this is ``|ours - s| <= tol``.
    With the requant, an output that is not ``R(s)`` must moreover be its
    neighbour on the result grid (exactly one step away: nothing of the grid
    lies between them), which happens only where ``s`` lies within ``tol``
    of a rounding midpoint, and at least ``MIN_EQUAL_FRACTION`` of the
    outputs must equal ``R(s)``.

    Returns ``(ok, {"equal_fraction", "steps", "max_abs"})``.
    """
    ours = torch.as_tensor(ours)
    s = plain_sum.to(torch.float32)
    tol = torch.as_tensor(tol, dtype=torch.float64, device=s.device)

    def out_map(v):
        if res_params is not None:
            v = quantize_block_plain(v, *res_params)
        return v.to(ours.dtype).to(torch.float32)

    o = ours.to(torch.float32)
    q = out_map(s)
    lo = out_map((s.double() - tol).to(torch.float32))
    hi = out_map((s.double() + tol).to(torch.float32))
    equal = (o == q) | (torch.isnan(o) & torch.isnan(q))
    ok_elem = equal | ((o >= lo) & (o <= hi))
    if res_params is not None:
        mid = out_map(((o.double() + q.double()) / 2).to(torch.float32))
        ok_elem = equal | (ok_elem & ((mid == o) | (mid == q)))
    frac = float(equal.to(torch.float64).mean()) if equal.numel() else 1.0
    ok = bool(ok_elem.all()) and (res_params is None or frac >= MIN_EQUAL_FRACTION)
    diff = (o - q).abs().nan_to_num(0.0)
    return ok, {"equal_fraction": frac, "steps": int((~equal).sum()),
                "max_abs": float(diff.max()) if diff.numel() else 0.0}


def sum_tolerance(x_eff, w_eff):
    """``K * 2^-24 * sum_k |x_k w_k|`` per output element, summed in f64,
    for the effective (bf16-valued) operands."""
    return x_eff.shape[1] * 2.0 ** -24 * (x_eff.double().abs() @ w_eff.double().abs())


def fused_quant_matmul_plain(x, w_q, act_params: Optional[QScalars] = None,
                             res_params: Optional[QScalars] = None, *,
                             quantize_x: bool = True, requantize_out: bool = False,
                             out_dtype=torch.float32):
    """K2's plain version: ``requant(quantize(x) @ w_q)`` with bf16
    operands and f32 sums."""
    _check_shapes(x, w_q, quantize_x)
    if quantize_x:
        x = quantize_block_plain(x, *(act_params or _zero_scalars()))
    out = sequential_matmul(x.to(torch.bfloat16).to(torch.float32),
                            w_q.to(torch.float32))
    if requantize_out:
        out = quantize_block_plain(out, *(res_params or _zero_scalars()))
    return out.to(out_dtype)


def _check_shapes(x, w, quantize_x):
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if quantize_x and x.dtype != torch.float32:
        raise TypeError(f"quantize_x takes float32 x, got {x.dtype}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("fused_matmul")
    q = lib.fp8q_quantize_block
    q.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p]
    q.restype = ctypes.c_int
    g = lib.fp8q_fused_quant_matmul
    g.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 5)
    g.restype = ctypes.c_int
    return q, g


def device_scalars(params: Optional[QScalars], device):
    """``(maxval, bias, mant, sign)`` as the kernels read them: a (1,) f32
    tensor and a (3,) int32 tensor on ``device``, built without a host
    round trip when the scalars already live there."""
    if params is None:
        return _unused_scalars(device)
    maxval, bias, mant, sign = params
    f = torch.as_tensor(maxval, dtype=torch.float32).to(device).reshape(1)
    i = torch.cat([to_int32(v).to(device).reshape(1) for v in (bias, mant, sign)])
    return f.contiguous(), i


@functools.lru_cache(maxsize=None)
def _unused_scalars(device):
    """Zero scalars for a switch that is off (the kernel does not read them)."""
    return (torch.zeros(1, dtype=torch.float32, device=device),
            torch.zeros(3, dtype=torch.int32, device=device))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _require_cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} takes CPU or CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    return dev


def quantize_block(x, maxval, bias_i, mant_i, sign_i):
    """K1: elementwise ExMy fake-quantize of an f32 tensor with per-tensor
    scalars (tensors on ``x``'s device, or numbers). Returns a new f32
    tensor shaped like ``x``. ``quantize_block.launches`` counts kernel
    launches."""
    x = torch.as_tensor(x)
    if x.device.type == "cpu":
        return quantize_block_plain(x, maxval, bias_i, mant_i, sign_i)
    dev = _require_cuda("quantize_block", x)
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_block takes float32, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    qf, qi = device_scalars((maxval, bias_i, mant_i, sign_i), dev)
    launch, _ = _lib()
    with torch.cuda.device(dev):
        err = launch(x.data_ptr(), out.data_ptr(), x.numel(), qf.data_ptr(),
                     qi.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"quantize_block kernel launch failed: CUDA error {err}")
    quantize_block.launches += 1
    return out


quantize_block.launches = 0


def fused_quant_matmul(x, w_q, act_params: Optional[QScalars] = None,
                       res_params: Optional[QScalars] = None, *,
                       quantize_x: bool = True, requantize_out: bool = False,
                       out_dtype=torch.float32):
    """K2: ``requant(quantize(x) @ w_q)``.

    x: (M, K) float32 (quantized by K1 on the load with ``quantize_x``) or
    bfloat16; w_q: (K, N) bfloat16 grid values; act/res params:
    ``(maxval, bias, mant, sign)`` scalars. Returns (M, N) in ``out_dtype``
    (float32 or bfloat16). One launch: route A (equal to
    :func:`fused_quant_matmul_plain` bit for bit) for M <=
    ``ROUTE_A_MAX_M``, route B (tensor cores, :func:`within_requant_step`'s
    contract) above. ``fused_quant_matmul.launches`` counts launches.
    """
    _check_shapes(x, w_q, quantize_x)
    if w_q.dtype != torch.bfloat16:
        raise TypeError(f"pre-quantized weights must be bfloat16, got {w_q.dtype}")
    kw = dict(quantize_x=quantize_x, requantize_out=requantize_out, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return fused_quant_matmul_plain(x, w_q, act_params, res_params, **kw)
    dev = _require_cuda("fused_quant_matmul", x, w_q)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    x, w_q = x.contiguous(), w_q.contiguous()
    af, ai = device_scalars(act_params if quantize_x else None, dev)
    rf, ri = device_scalars(res_params if requantize_out else None, dev)
    _, launch = _lib()
    with torch.cuda.device(dev):
        err = launch(x.data_ptr(), w_q.data_ptr(), out.data_ptr(), m, n, k, ROUTE_A_MAX_M,
                     int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                     int(quantize_x), int(requantize_out), af.data_ptr(), ai.data_ptr(),
                     rf.data_ptr(), ri.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_quant_matmul kernel launch failed: CUDA error {err}")
    fused_quant_matmul.launches += 1
    return out


fused_quant_matmul.launches = 0

