"""The bit-ops ExMy quantizer (K1) and the fused quantize -> matmul ->
requantize GEMM (K2): wrappers of the CUDA kernels in
``csrc/fused_matmul.cu`` and their plain PyTorch versions.

Replace ``fp8_quantization_tpu/ops/pallas/fused_matmul.py::quantize_block``
and ``::fused_quant_matmul`` and take the same arguments. A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.

The products of the GEMMs (here and in ``dequant_matmul``) multiply bf16
operands, so every product is exact in f32; the plain version sums them in
f32 in ascending k (:func:`sequential_matmul`), which the kernel does too,
so kernel and plain version agree bit for bit. Against the JAX package,
whose XLA dot sums in another order, they agree to
``K * 2^-24 * sum_k |x_k w_k|`` per element.
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
    g.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5)
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
    (float32 or bfloat16). ``fused_quant_matmul.launches`` counts launches.
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
        err = launch(x.data_ptr(), w_q.data_ptr(), out.data_ptr(), m, n, k,
                     int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                     int(quantize_x), int(requantize_out), af.data_ptr(), ai.data_ptr(),
                     rf.data_ptr(), ri.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_quant_matmul kernel launch failed: CUDA error {err}")
    fused_quant_matmul.launches += 1
    return out


fused_quant_matmul.launches = 0

