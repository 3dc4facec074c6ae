"""Packed-FP8 weight storage and the fused dequantize -> matmul GEMM (K4),
and the int4 nibble GEMM (K5): wrappers of the CUDA kernels in
``csrc/dequant_matmul.cu`` and ``csrc/int4_matmul.cu`` and their plain
PyTorch versions.

Replace ``fp8_quantization_tpu/ops/pallas/dequant_matmul.py::dequant_matmul``
and ``::int4_matmul`` and take the same arguments; ``PackedWeights``,
``pack_weights`` and ``unpack_weights`` are ported from the same module. Weights live on the
device as 1-byte ExMy codes (``s:1 | e:E | m:M``) with a per-channel packing
bias and are decoded inside the kernel. A tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises.

Packing fidelity (``pack_weights``): the STE quantizer rounds its exponent
bias, which places some channels' grids one binade high, so their top codes
need exponent ``2^E``, one past the field. Channels that fit pack bit-exactly
with the STE bias; the others re-quantize onto the ``bias - 1`` grid, which
moves only bottom-binade subnormal values by at most half an ULP of the
smallest magnitude. ``PackedWeights.exact_fraction`` reports the split.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ...numerics.codec import (
    pack_exmy,
    quantize_exmy,
    unpack_consts,
    unpack_exmy,
    unpack_exmy_bits,
)
from ...numerics.rounding import to_int32
from . import build
from .fused_matmul import (
    ROUTE_A_MAX_M,
    QScalars,
    _require_cuda,
    _stream,
    _zero_scalars,
    device_scalars,
    quantize_block_plain,
    sequential_matmul,
)


class PackedWeights(NamedTuple):
    codes: torch.Tensor           # (K, N) uint8 ExMy codes
    bias: torch.Tensor            # (N,) int32 per-channel packing bias
    exact_fraction: torch.Tensor  # f32 scalar: fraction of channels bit-exact
    expo_width: int
    mant_width: int


# weight elements packed per pass: a full-width weight (Llama-3-8B's lm_head
# is 4096 x 128256) packs a slice of columns at a time instead of holding a
# dozen full-size f32 temporaries at once; every step is per column
PACK_CHUNK_ELEMENTS = 1 << 26


def pack_weights(w_q, w_bias, expo_width: int, mant_width: int) -> PackedWeights:
    """Pack STE-quantized (K, N) weights, already on their ExMy grid, into
    per-channel byte codes. ``w_bias`` is the weight quantizer's derived
    per-channel bias, (N,) or (1,)."""
    w_q = torch.as_tensor(w_q)
    k, n = w_q.shape
    bias = to_int32(w_bias, w_q.device).reshape(-1).expand(n).contiguous()
    step = max(1, PACK_CHUNK_ELEMENTS // max(k, 1))
    parts = [_pack_columns(w_q[:, c:c + step].to(torch.float32), bias[c:c + step],
                           expo_width, mant_width) for c in range(0, n, step)]
    codes, bias_pack, exact = (torch.cat(p, dim=-1) for p in zip(*parts))
    # the mean as XLA takes it: the sum times the reciprocal of the count
    return PackedWeights(codes=codes, bias=bias_pack,
                         exact_fraction=exact.to(torch.float32).sum() * (1.0 / n),
                         expo_width=expo_width, mant_width=mant_width)


def _pack_columns(w_q, bias, expo_width: int, mant_width: int):
    """(codes, packing bias, value-exact) of some columns of ``pack_weights``."""
    codes0 = pack_exmy(w_q, expo_width, mant_width, bias[None, :])
    fits = torch.all(unpack_exmy(codes0, expo_width, mant_width, bias[None, :]) == w_q,
                     dim=0)
    bias1 = bias - 1
    w_q1 = quantize_exmy(w_q, expo_width, mant_width, bias1[None, :])
    codes1 = pack_exmy(w_q1, expo_width, mant_width, bias1[None, :])

    codes = torch.where(fits[None, :], codes0, codes1)
    bias_pack = torch.where(fits, bias, bias1)
    # a bias-1 channel can still be value-exact (its misfit codes were all
    # top-binade, which the bias-1 grid holds exactly): report value equality
    exact = torch.all(
        unpack_exmy(codes, expo_width, mant_width, bias_pack[None, :]) == w_q, dim=0)
    return codes, bias_pack, exact


def unpack_weights(pw: PackedWeights, dtype=torch.float32):
    """Reference decode (the kernel's golden)."""
    return unpack_exmy(pw.codes, pw.expo_width, pw.mant_width, pw.bias[None, :],
                       dtype=dtype)


def _check(x, w_codes, x_bias, x_expo, x_mant, quantize_x):
    if x.ndim != 2 or w_codes.ndim != 2 or x.shape[1] != w_codes.shape[0]:
        raise ValueError(f"bad shapes {tuple(x.shape)} @ {tuple(w_codes.shape)}")
    if w_codes.dtype != torch.uint8:
        raise TypeError(f"w_codes must be uint8, got {w_codes.dtype}")
    if x_bias is not None:
        if x.dtype != torch.uint8 or quantize_x:
            raise TypeError("coded x must be uint8 and is not quantized again")
        if x_expo is None or x_mant is None:
            raise ValueError("coded x needs x_expo and x_mant")
    elif x.dtype == torch.uint8:
        raise TypeError("uint8 x needs x_bias (the coded-x path)")
    elif quantize_x and x.dtype != torch.float32:
        raise TypeError(f"quantize_x takes float32 x, got {x.dtype}")


def dequant_matmul_plain(x, w_codes, w_bias, *, expo_width: int, mant_width: int,
                         act_params: Optional[QScalars] = None,
                         res_params: Optional[QScalars] = None, x_bias=None,
                         x_expo: Optional[int] = None, x_mant: Optional[int] = None,
                         quantize_x: bool = False, requantize_out: bool = False,
                         out_dtype=torch.float32):
    """K4's plain version: decode x (coded) or quantize it (``quantize_x``),
    decode the weight codes to bf16, sum the bf16 products in f32 in
    ascending k, requantize."""
    _check(x, w_codes, x_bias, x_expo, x_mant, quantize_x)
    if x_bias is not None:
        xeb, xss = unpack_consts(to_int32(x_bias, x.device).reshape(()), x_mant)
        x = unpack_exmy_bits(x, x_expo, x_mant, xeb, xss, dtype=torch.bfloat16)
    elif quantize_x:
        x = quantize_block_plain(x, *(act_params or _zero_scalars()))
    web, wss = unpack_consts(to_int32(w_bias, w_codes.device).reshape(1, -1), mant_width)
    w = unpack_exmy_bits(w_codes, expo_width, mant_width, web, wss, dtype=torch.bfloat16)
    out = sequential_matmul(x.to(torch.bfloat16).to(torch.float32), w.to(torch.float32))
    if requantize_out:
        out = quantize_block_plain(out, *(res_params or _zero_scalars()))
    return out.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.load("dequant_matmul").fp8q_dequant_matmul
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _no_codes(device):
    return torch.zeros(1, dtype=torch.int32, device=device)


def dequant_matmul(x, w_codes, w_bias, *, expo_width: int, mant_width: int,
                   act_params: Optional[QScalars] = None,
                   res_params: Optional[QScalars] = None, x_bias=None,
                   x_expo: Optional[int] = None, x_mant: Optional[int] = None,
                   quantize_x: bool = False, requantize_out: bool = False,
                   out_dtype=torch.float32):
    """K4: ``requant(quantize(x) @ decode(w_codes))``.

    x: (M, K) bfloat16 (already quantized), float32 (quantized by K1 on the
    load with ``quantize_x`` + ``act_params``, else rounded to bf16), or
    uint8 ExMy codes with a per-tensor ``x_bias`` and ``x_expo``/``x_mant``
    (the chained serving path). w_codes: (K, N) uint8; w_bias: (N,) int32
    packing bias. Returns (M, N) in ``out_dtype`` (float32 or bfloat16).
    One launch: route A (equal to :func:`dequant_matmul_plain` bit for bit)
    for M <= ``fused_matmul.ROUTE_A_MAX_M``, route B (tensor cores,
    ``fused_matmul.within_requant_step``'s contract) above.
    ``dequant_matmul.launches`` counts kernel launches.
    """
    kw = dict(expo_width=expo_width, mant_width=mant_width, act_params=act_params,
              res_params=res_params, x_bias=x_bias, x_expo=x_expo, x_mant=x_mant,
              quantize_x=quantize_x, requantize_out=requantize_out, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, w_codes, w_bias, **kw)
    _check(x, w_codes, x_bias, x_expo, x_mant, quantize_x)
    dev = _require_cuda("dequant_matmul", x, w_codes)
    if x.dtype not in (torch.float32, torch.bfloat16, torch.uint8):
        raise TypeError(f"x must be float32, bfloat16 or uint8 codes, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    m, k = x.shape
    n = w_codes.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    x, w_codes = x.contiguous(), w_codes.contiguous()
    # the kernel derives the decode constants (codec.unpack_consts) itself
    w_bias = to_int32(w_bias, dev).reshape(-1)
    if w_bias.numel() not in (1, n):
        raise ValueError(f"w_bias has {w_bias.numel()} entries for {n} columns")
    w_bias = w_bias.expand(n).contiguous()
    if x_bias is not None:
        x_bias = to_int32(x_bias, dev).reshape(1)
        x_mode = 2
    else:
        x_bias = _no_codes(dev)
        x_mode = 1 if x.dtype == torch.bfloat16 else 0
    af, ai = device_scalars(act_params if quantize_x else None, dev)
    rf, ri = device_scalars(res_params if requantize_out else None, dev)
    with torch.cuda.device(dev):
        err = _lib()(x.data_ptr(), w_codes.data_ptr(), out.data_ptr(), m, n, k, ROUTE_A_MAX_M,
                     x_mode,
                     int(out_dtype == torch.bfloat16), int(quantize_x), int(requantize_out),
                     af.data_ptr(), ai.data_ptr(), rf.data_ptr(), ri.data_ptr(),
                     expo_width, mant_width, w_bias.data_ptr(), x_expo or 0, x_mant or 0,
                     x_bias.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"dequant_matmul kernel launch failed: CUDA error {err}")
    dequant_matmul.launches += 1
    return out


dequant_matmul.launches = 0


# K5 sums 16 x each product in int32 (see csrc/int4_matmul.cu)
INT4_MAX_K = 65536


def _check_int4(x_codes, w4, k: int):
    if (x_codes.ndim != 2 or w4.ndim != 2 or x_codes.shape[1] != k
            or w4.shape[0] != -(-k // 2)):
        raise ValueError(f"bad shapes {tuple(x_codes.shape)} @ packed {tuple(w4.shape)} "
                         f"for k={k}")
    if x_codes.dtype != torch.int8 or w4.dtype != torch.uint8:
        raise TypeError(f"int4_matmul takes int8 x codes and uint8 nibble pairs, got "
                        f"{x_codes.dtype} and {w4.dtype}")


def int4_matmul_plain(x_codes, w4, *, k: int):
    """K5's plain version, the JAX package's off-TPU branch: unpack the
    nibbles (``fastpath.unpack_int4``) and take the exact int32 product
    (``fastpath.int8_matmul``)."""
    from ..fastpath import int8_matmul, unpack_int4

    _check_int4(x_codes, w4, k)
    return int8_matmul(x_codes, unpack_int4(w4, k))


@functools.lru_cache(maxsize=None)
def _int4_lib():
    fn = build.load("int4_matmul").fp8q_int4_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int4_matmul(x_codes, w4, *, k: int):
    """K5: int8 activation codes times nibble-packed int4 weight codes, the
    exact int32 product ``x_codes @ unpack_int4(w4, k)``.

    x_codes: (M, K) int8 (``fastpath.quantize_acts_int8``); w4: (ceil(K/2), N)
    uint8 from ``fastpath.pack_int4`` (split-K halves). Returns (M, N) int32;
    the zero points and scales are the caller's (``quantized_matmul_int8``
    with ``acc=``). One launch, equal to :func:`int4_matmul_plain` bit for
    bit on either route: route A (weight streaming, K split across a
    cluster) for M <= ``fused_matmul.ROUTE_A_MAX_M``, route B (row tiles)
    above, both on the int8 tensor cores. ``int4_matmul.launches`` counts
    kernel launches.
    """
    if x_codes.device.type == "cpu":
        return int4_matmul_plain(x_codes, w4, k=k)
    _check_int4(x_codes, w4, k)
    dev = _require_cuda("int4_matmul", x_codes, w4)
    if k > INT4_MAX_K:
        raise ValueError(f"int4_matmul takes K <= {INT4_MAX_K}, got {k}")
    m, n = x_codes.shape[0], w4.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=dev)
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    x_codes, w4 = x_codes.contiguous(), w4.contiguous()
    with torch.cuda.device(dev):
        err = _int4_lib()(x_codes.data_ptr(), w4.data_ptr(), out.data_ptr(), m, n, k,
                          ROUTE_A_MAX_M, _stream(dev))
    if err != 0:
        raise RuntimeError(f"int4_matmul kernel launch failed: CUDA error {err}")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0
