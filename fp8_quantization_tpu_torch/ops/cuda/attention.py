"""Fused scaled-dot-product attention with an optional FP8 requant epilogue
(K7): wrapper of the CUDA kernel in ``csrc/attention.cu`` and its plain
PyTorch version.

Replaces ``fp8_quantization_tpu/ops/pallas/attention.py::fused_sdpa`` and
takes the same arguments. Operands are token-major, ``(B, T, H, D)`` queries
over ``(B, S, HK, D)`` keys and values, with GQA by head index (q head ``h``
reads kv head ``h // (H / HK)``). A tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises. The TPU kernel holds
the whole key axis in VMEM and its callers fall back to einsum beyond a size
(``sdpa_fits_vmem``); this kernel streams the key axis, so it takes every
length and there is no fallback.

Numerics, as the TPU kernel computes them: operands rounded to bf16, scores
``dot(q, k) * (1 / sqrt(D))`` with f32 sums (each product of two bf16 values
is exact in f32), masked scores ``-1e30``, ``p = exp(s - max)``,
``l = sum(p)``, and the *normalized* probabilities ``p / l`` rounded to bf16
before the f32 ``p @ v``. The plain version also takes the kernel's order:
each score summed over d ascending, the row max and ``l`` online over key
tiles of 64 with each tile's sum reduced as the kernel's warp reduces it,
and ``p @ v`` summed over keys ascending, so the two agree bit for bit where
their ``exp`` does (the stated tolerance, ``2e-3 * max(1, max|plain|)``, is
the JAX attention tests' own 2e-3, which the plain version meets against
the Pallas kernel).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .fused_matmul import (
    QScalars,
    _require_cuda,
    _stream,
    _zero_scalars,
    device_scalars,
    quantize_block_plain,
)

# the kernel's limit on the head dim (its shared-memory tiles and
# per-thread accumulators are sized for it)
MAX_HEAD_DIM = 256


def _check(q, k, v, offsets, causal):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, T, H, D) and k, v one (B, S, HK, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if h % k.shape[2] != 0:
        raise ValueError("kv heads must divide q heads (GQA)")
    if offsets is not None and not causal:
        raise ValueError("offsets apply to causal attention only")


def _offsets(offsets, b, device):
    return torch.as_tensor(offsets).to(device=device, dtype=torch.int32).reshape(b)


# the kernel's key tile and warp width (csrc/attention.cu)
KEY_TILE = 64
LANES = 32


def warp_sum(x):
    """Sum over the last axis (32 lanes) in the order of a warp's xor-shuffle
    reduction: halves added pairwise, 16 then 8, 4, 2 and 1 apart."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def fused_sdpa_plain(q, k, v, *, s_valid: Optional[int] = None, causal: bool = False,
                     offsets=None, res_params: Optional[QScalars] = None,
                     requantize_out: bool = False, out_dtype=torch.float32):
    """K7's plain version: the TPU kernel's rounding points in the CUDA
    kernel's order (see the module docstring)."""
    _check(q, k, v, offsets, causal)
    b, t, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    s_valid = sk if s_valid is None else s_valid
    dev = q.device
    qf, kf, vf = (x.to(torch.bfloat16).to(torch.float32) for x in (q, k, v))
    qg = qf.reshape(b, t, hk, h // hk, d).permute(0, 2, 3, 1, 4)      # (B, HK, G, T, D)
    kt, vt = kf.permute(0, 2, 1, 3), vf.permute(0, 2, 1, 3)           # (B, HK, S, D)
    scores = torch.zeros((b, hk, h // hk, t, sk), device=dev)
    for i in range(d):
        scores.addcmul_(qg[..., i, None], kt[:, :, None, None, :, i])
    scores = scores * torch.tensor(1.0 / float(d) ** 0.5, dtype=torch.float32, device=dev)
    key = torch.arange(sk, device=dev)
    mask = (key < s_valid)[None, None, :]                             # (1, 1, S)
    if causal:
        row = torch.arange(t, device=dev)[None, :]
        if offsets is not None:
            row = row + _offsets(offsets, b, dev)[:, None]
        mask = mask & (key[None, None, :] <= row[:, :, None])         # (B, T, S)
    scores = torch.where(mask.expand(b, t, sk)[:, None, None], scores,
                         torch.tensor(-1e30, device=dev))
    # row max and sum online over key tiles; keys past S do not exist (-inf)
    tiles = F.pad(scores, (0, -sk % KEY_TILE), value=-torch.inf)
    m = torch.full(scores.shape[:-1], -torch.inf, device=dev)
    l = torch.zeros_like(m)
    for c0 in range(0, tiles.shape[-1], KEY_TILE):
        tile = tiles[..., c0:c0 + KEY_TILE]
        m_new = torch.maximum(m, tile.amax(dim=-1))
        e = torch.exp(tile - m_new[..., None])
        l = l * torch.exp(m - m_new) + warp_sum(e[..., :LANES] + e[..., LANES:])
        m = m_new
    probs = (torch.exp(scores - m[..., None]) / l[..., None]).to(torch.bfloat16).to(torch.float32)
    acc = torch.zeros((b, hk, h // hk, t, d), device=dev)
    for c in range(sk):
        acc.addcmul_(probs[..., c, None], vt[:, :, None, None, c])
    ctx = acc.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)
    if requantize_out or res_params is not None:
        ctx = quantize_block_plain(ctx, *(res_params or _zero_scalars()))
    return ctx.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.load("attention").fp8q_fused_sdpa
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _no_offsets(device):
    return torch.zeros(1, dtype=torch.int32, device=device)


def fused_sdpa(q, k, v, *, s_valid: Optional[int] = None, causal: bool = False,
               offsets=None, res_params: Optional[QScalars] = None,
               requantize_out: bool = False, out_dtype=torch.float32):
    """K7: ``softmax(q k^T / sqrt(D)) v`` over token-major operands.

    q: (B, T, H, D); k, v: (B, S, HK, D) with HK dividing H (S may exceed T:
    a cache slab), any float dtype (taken as bf16). ``s_valid`` caps the
    valid keys (default S); ``causal`` masks ``key > row [+ offsets[b]]``;
    ``offsets``: (B,) int32 position of each batch's query row 0 (warm
    prefill over a cache slab). ``res_params`` (or ``requantize_out``):
    ``(maxval, bias, mant, sign)`` of the FP8 site the context is requantized
    onto in the epilogue. Returns (B, T, H, D) in ``out_dtype`` (float32 or
    bfloat16). The TPU kernel's query block ``bq`` has no counterpart: query
    rows are independent, so no block size changes a value.
    ``fused_sdpa.launches`` counts kernel launches.
    """
    kw = dict(s_valid=s_valid, causal=causal, offsets=offsets, res_params=res_params,
              requantize_out=requantize_out, out_dtype=out_dtype)
    if q.device.type == "cpu":
        return fused_sdpa_plain(q, k, v, **kw)
    _check(q, k, v, offsets, causal)
    dev = _require_cuda("fused_sdpa", q, k, v)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    b, t, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernel's {MAX_HEAD_DIM}")
    s_valid = sk if s_valid is None else int(s_valid)
    out = torch.empty((b, t, h, d), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    q16, k16, v16 = (x.to(torch.bfloat16).contiguous() for x in (q, k, v))
    off = _no_offsets(dev) if offsets is None else _offsets(offsets, b, dev).contiguous()
    requant = requantize_out or res_params is not None
    rf, ri = device_scalars(res_params if requant else None, dev)
    with torch.cuda.device(dev):
        err = _lib()(q16.data_ptr(), k16.data_ptr(), v16.data_ptr(), out.data_ptr(),
                     b, t, h, sk, hk, d, s_valid, int(causal), int(offsets is not None),
                     off.data_ptr(), int(requant), int(out_dtype == torch.bfloat16),
                     rf.data_ptr(), ri.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_sdpa kernel launch failed: CUDA error {err}")
    fused_sdpa.launches += 1
    return out


fused_sdpa.launches = 0
