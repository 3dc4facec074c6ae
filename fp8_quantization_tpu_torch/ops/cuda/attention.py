"""Fused scaled-dot-product attention with an optional FP8 requant epilogue
(K7): wrapper of the CUDA kernel in ``csrc/attention.cu``, its plain PyTorch
version and the contract that holds one to the other.

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
before the f32 ``p @ v``. The plain version sums each score over d
ascending, takes the row max and ``l`` online over key tiles of 64 (each
tile's sum reduced as a warp reduces it) and sums ``p @ v`` over keys
ascending; it meets the JAX attention tests' own ``2e-3`` against the
Pallas kernel. The kernel runs ``q k^T`` and ``p v`` on the tensor cores,
which sum in their own order, so it is held to the plain version by
:func:`within_sdpa_contract`, a bound derived from that order alone.
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
    within_requant_step,
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


def _plain_parts(q, k, v, s_valid, causal, offsets, descending=False):
    """The plain version's intermediates, by kv head and group:
    ``(B, HK, G, T, ...)`` operands ``qg`` and ``(B, HK, S, D)`` ``kt``, ``vt``
    (bf16 values in f32), the ``mask``, the scaled and masked ``scores``, the
    rows' ``m`` and ``l``, the normalized ``x = p / l`` in f32, the bf16
    ``probs`` and the f32 context ``acc``. ``descending`` sums each score
    over d and ``p @ v`` over keys in descending order instead."""
    _check(q, k, v, offsets, causal)
    b, t, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    s_valid = sk if s_valid is None else s_valid
    dev = q.device
    qf, kf, vf = (x.to(torch.bfloat16).to(torch.float32) for x in (q, k, v))
    qg = qf.reshape(b, t, hk, h // hk, d).permute(0, 2, 3, 1, 4)      # (B, HK, G, T, D)
    kt, vt = kf.permute(0, 2, 1, 3), vf.permute(0, 2, 1, 3)           # (B, HK, S, D)
    scores = torch.zeros((b, hk, h // hk, t, sk), device=dev)
    for i in (reversed(range(d)) if descending else range(d)):
        scores.addcmul_(qg[..., i, None], kt[:, :, None, None, :, i])
    scores = scores * torch.tensor(1.0 / float(d) ** 0.5, dtype=torch.float32, device=dev)
    key = torch.arange(sk, device=dev)
    mask = (key < s_valid)[None, None, :]                             # (1, 1, S)
    if causal:
        row = torch.arange(t, device=dev)[None, :]
        if offsets is not None:
            row = row + _offsets(offsets, b, dev)[:, None]
        mask = mask & (key[None, None, :] <= row[:, :, None])         # (B, T, S)
    mask = mask.expand(b, t, sk)[:, None, None]                       # (B, 1, 1, T, S)
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=dev))
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
    x = torch.exp(scores - m[..., None]) / l[..., None]
    probs = x.to(torch.bfloat16).to(torch.float32)
    acc = torch.zeros((b, hk, h // hk, t, d), device=dev)
    for c in (reversed(range(sk)) if descending else range(sk)):
        acc.addcmul_(probs[..., c, None], vt[:, :, None, None, c])
    return dict(qg=qg, kt=kt, vt=vt, mask=mask, scores=scores, m=m, l=l, x=x, probs=probs,
                acc=acc)


def _context(acc):
    """(B, HK, G, T, D) -> (B, T, H, D)."""
    b, hk, g, t, d = acc.shape
    return acc.permute(0, 3, 1, 2, 4).reshape(b, t, hk * g, d)


def fused_sdpa_plain(q, k, v, *, s_valid: Optional[int] = None, causal: bool = False,
                     offsets=None, res_params: Optional[QScalars] = None,
                     requantize_out: bool = False, out_dtype=torch.float32,
                     descending: bool = False):
    """K7's plain version: the TPU kernel's rounding points, with f32 sums
    in the order the module docstring gives (``descending``: each score
    over d and ``p @ v`` over keys in descending order, another legal
    order)."""
    ctx = _context(_plain_parts(q, k, v, s_valid, causal, offsets, descending)["acc"])
    if requantize_out or res_params is not None:
        ctx = quantize_block_plain(ctx, *(res_params or _zero_scalars()))
    return ctx.to(out_dtype)


U = 2.0 ** -24   # f32 unit roundoff


def within_sdpa_contract(ours, q, k, v, *, s_valid: Optional[int] = None,
                         causal: bool = False, offsets=None,
                         res_params: Optional[QScalars] = None, requantize_out: bool = False):
    """K7's numerics contract: whether ``ours`` (a ``fused_sdpa`` output on
    these arguments, in its own dtype) is a value that the function gives
    with f32 sums taken in another order. Derived from the arithmetic, per
    row and key, against the plain version's own intermediates:

    - score: the D exact bf16 products summed in f32 in two orders differ
      by at most ``D * U * sum_d |q_d k_d|`` (the convention of
      ``fused_matmul.sum_tolerance``, U = 2^-24), and the scaling rounds each
      once more: ``delta = (D + 2) * U * sum_d |q_d k_d| * scale``; masked
      scores are the constant -1e30 on both sides;
    - max: ``|m' - m| <= max_j delta_j`` over the row's unmasked keys;
    - ``p = exp(s - m)``: relative ``eta = expm1(delta + |m' - m| + 2U|s -
      m| + 8U)`` (both subtractions round, each ``exp`` within 2 ulp);
    - ``l``: relative ``rho = max eta + U * (n + 10 * tiles)`` for n
      nonzero terms (two orders) and one rescale of 5U a side per
      ``KEY_TILE``-key tile of S;
    - ``p / l`` within ``[(1 - eta)(1 - U) / ((1 + rho)(1 + U)), (1 + eta)(1
      + U) / ((1 - rho)(1 - U))]`` of the plain one (each side's quotient
      correctly rounded; where it is subnormal, within a further 2^-149),
      so each bf16 probability is the plain one or the bf16 value at the
      other end of that interval (a neighbour, where the interval holds a
      rounding point);
    - context: ``sum_j dp_j |v_jd|`` for those flips plus the f32 order term
      of ``p @ v``, ``n * U * sum_j (p_j + dp_j) |v_jd|``.

    The context is then held as ``fused_matmul.within_requant_step`` holds a
    GEMM to its sum tolerance: in f32 within the bound; cast to bf16, the
    cast of a value within it; with the requant epilogue, each output equal
    to the plain one or its grid neighbour at a rounding midpoint, at least
    ``MIN_EQUAL_FRACTION`` equal. Returns ``(ok, info)``: ``info`` has the
    equal fraction, the outputs not equal, the max |d| and, for an f32
    output without requant, ``worst_ratio``, the largest |d| / bound.
    """
    parts = _plain_parts(q, k, v, s_valid, causal, offsets)
    d, sk = q.shape[-1], k.shape[1]
    mask = parts["mask"]
    scale = float(torch.tensor(1.0 / float(d) ** 0.5, dtype=torch.float32))
    absdot = parts["qg"].double().abs() @ parts["kt"].double().abs().transpose(-1, -2)[:, :, None]
    delta = torch.where(mask, (d + 2) * U * scale * absdot, 0.0)
    dm = delta.amax(dim=-1, keepdim=True)
    x = parts["x"].double()
    live = mask & (x > 0)
    e = (parts["scores"].double() - parts["m"].double()[..., None]).abs()
    eta = torch.where(live, torch.expm1(delta + dm + 2 * U * e.nan_to_num(0.0) + 8 * U), 0.0)
    n = (x > 0).sum(dim=-1, keepdim=True).double()
    rho = eta.amax(dim=-1, keepdim=True) + U * (n + 10 * -(-sk // KEY_TILE))
    hi = x * (1 + eta) * (1 + U) / ((1 - rho) * (1 - U)) * (1 + 2.0 ** -22) + 2.0 ** -149
    lo = (x * (1 - eta) * (1 - U) / ((1 + rho) * (1 + U)) * (1 - 2.0 ** -22)
          - 2.0 ** -149).clamp(min=0.0)
    p = parts["probs"].double()

    def bf16(y):
        return y.float().to(torch.bfloat16).double()

    dp = torch.maximum(bf16(hi) - p, p - bf16(lo))
    va = parts["vt"].double().abs()[:, :, None]                      # (B, HK, 1, S, D)
    n_pv = ((p + dp) > 0).sum(dim=-1, keepdim=True).double()
    tol = dp @ va + n_pv * U * ((p + dp) @ va)
    requant = requantize_out or res_params is not None
    res = (res_params or _zero_scalars()) if requant else None
    plain = _context(parts["acc"])
    ok, info = within_requant_step(ours, plain, _context(tol), res)
    if not requant and torch.as_tensor(ours).dtype == torch.float32:
        diff = (ours.double() - plain.double()).abs()
        ratio = torch.where(diff > 0, diff / _context(tol), 0.0)
        info["worst_ratio"] = float(ratio.max()) if ratio.numel() else 0.0
    return ok and bool(torch.isfinite(torch.as_tensor(ours).float()).all()), info


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
