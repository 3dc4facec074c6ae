"""Decode attention over a KV-cache slab (K6): wrapper of the CUDA kernel in
``csrc/decode_attention.cu`` and its plain PyTorch version.

Replaces ``fp8_quantization_tpu/ops/pallas/decode_attention.py::
decode_attention`` and takes the same arguments: one query token per slot
over a ``(B, S, HK, D)`` slab of bf16 grid values, or of uint8 ExMy codes
with per-tensor packing biases (decoded on the load), masked per slot by
``lengths``. A tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.

Both walk the TPU kernel's key blocks (``bs = min(bs, round_up(S, 128))``,
S padded to a multiple) in order with its online softmax, rounding the
unnormalized ``p = exp(s - m_new)`` to bf16 before ``p @ v``. The kernel
spreads each block over a cluster of CTAs, one sub-chunk of ``SUB_CHUNK``
keys each, and the plain version takes the kernel's order of every sum, so
the two are equal bit for bit where their ``exp`` does:

- each score: the products summed over d in order, one f32 chain;
- the block max is order-free, so ``m_new``, ``corr`` and ``p`` are the TPU
  kernel's;
- a sub-chunk's ``sum(p)``: lane ``l`` adds ``p[l]`` and ``p[l + 32]``, then
  the warp's xor tree (:func:`~.attention.warp_sum`); its ``bf16(p) @ v``:
  one f32 chain per output over its keys in order;
- the block's ``sum(p)`` and ``p @ v``: the sub-chunks' partial sums added
  in ascending sub-chunk order, then ``l = l * corr + sum`` and
  ``acc = acc * corr + pv``.

Against the Pallas kernel, whose sums run in XLA's order, the plain version
agrees within the JAX attention tests' own ``2e-3``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ...numerics.codec import unpack_consts, unpack_exmy_bits
from ...numerics.rounding import to_int32
from . import build
from .attention import LANES, warp_sum
from .fused_matmul import _require_cuda, _stream


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check(q, k_slab, v_slab, lengths, k_bias, v_bias, kv_expo, kv_mant, bs):
    if q.ndim != 3 or k_slab.ndim != 4 or v_slab.shape != k_slab.shape:
        raise ValueError(f"q must be (B, H, D) and the slabs one (B, S, HK, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k_slab.shape)}, {tuple(v_slab.shape)}")
    b, h, d = q.shape
    if k_slab.shape[0] != b or k_slab.shape[3] != d or k_slab.shape[1] < 1:
        raise ValueError(f"slab {tuple(k_slab.shape)} does not match q {tuple(q.shape)}")
    if h % k_slab.shape[2] != 0:
        raise ValueError("kv heads must divide q heads (GQA)")
    if tuple(torch.as_tensor(lengths).shape) != (b,):
        raise ValueError(f"lengths must be ({b},)")
    if bs < 1:
        raise ValueError(f"bs must be positive, got {bs}")
    if k_bias is not None:
        if k_slab.dtype != torch.uint8 or v_slab.dtype != torch.uint8 or v_bias is None:
            raise TypeError("a coded cache is uint8 with a k_bias and a v_bias")
        if kv_expo is None or kv_mant is None:
            raise ValueError("a coded cache needs kv_expo and kv_mant")
    elif k_slab.dtype == torch.uint8:
        raise TypeError("a uint8 cache needs k_bias and v_bias (the coded path)")


def block_size(s: int, bs: int = 512) -> int:
    """The key block both versions walk: ``min(bs, round_up(S, 128))``."""
    return min(bs, _round_up(s, 128))


# keys of a block that one CTA of the kernel's cluster takes, and the most
# sub-chunks a block may have (the cluster's size; csrc/decode_attention.cu)
SUB_CHUNK = 64
MAX_SUB_CHUNKS = 8
# the kernel's limits on the head dim and on query heads per kv head
MAX_HEAD_DIM = 256
MAX_GROUP = 8


def decode_attention_plain(q, k_slab, v_slab, lengths, *, k_bias=None, v_bias=None,
                           kv_expo: Optional[int] = None, kv_mant: Optional[int] = None,
                           bs: int = 512):
    """K6's plain version: the TPU kernel's blocks and online softmax in the
    CUDA kernel's order (see the module docstring), vectorized over slots,
    heads and sub-chunks. Keys at or past every slot's length add exact
    zeros, so the walk stops there."""
    _check(q, k_slab, v_slab, lengths, k_bias, v_bias, kv_expo, kv_mant, bs)
    b, h, d = q.shape
    s, hk = k_slab.shape[1], k_slab.shape[2]
    g = h // hk
    dev = q.device
    bs = block_size(s, bs)
    sp = _round_up(s, bs)
    nsub = -(-bs // SUB_CHUNK)
    lens = torch.as_tensor(lengths).to(device=dev, dtype=torch.int32)
    kend = int(torch.where(lens >= 1, lens.clamp(max=sp), sp).max())

    def load(slab, bias, rows):
        if bias is None:
            x = slab.to(torch.bfloat16)
        else:
            eb, ss = unpack_consts(to_int32(bias, dev).reshape(()), kv_mant)
            x = unpack_exmy_bits(slab, kv_expo, kv_mant, eb, ss, dtype=torch.bfloat16)
        # (B, HK, rows, D): zero rows past S, as the TPU kernel pads
        return F.pad(x.to(torch.float32), (0, 0, 0, 0, 0, rows - s)).permute(0, 2, 1, 3)

    # v also pads the last block's sub-chunks to SUB_CHUNK keys each
    kf = load(k_slab, k_bias, sp)
    vf = load(v_slab, v_bias, sp - bs + nsub * SUB_CHUNK)
    qg = q.to(torch.bfloat16).to(torch.float32).reshape(b, hk, g, d)
    scale = torch.tensor(1.0 / float(d) ** 0.5, dtype=torch.float32, device=dev)
    masked = torch.tensor(-1e30, device=dev)
    m = torch.full((b, hk, g), -1e30, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hk, g, d), device=dev)
    for base in range(0, kend, bs):
        # each score summed over d in order, one f32 chain
        scores = torch.zeros((b, hk, g, bs), device=dev)
        for j in range(d):
            scores.addcmul_(qg[:, :, :, None, j], kf[:, :, None, base:base + bs, j])
        scores = scores * scale                                          # (B, HK, G, bs)
        pos = base + torch.arange(bs, device=dev)
        scores = torch.where((pos[None, :] < lens[:, None])[:, None, None, :], scores, masked)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = F.pad(torch.exp(scores - m_new[..., None]), (0, nsub * SUB_CHUNK - bs))
        p = p.unflatten(-1, (nsub, SUB_CHUNK))                           # (..., nsub, SUB)
        # each sub-chunk's sum(p): lane l adds p[l], p[l + 32], then the tree
        halves = p.unflatten(-1, (SUB_CHUNK // LANES, LANES))
        lane_sums = halves[..., 0, :]
        for row in range(1, SUB_CHUNK // LANES):
            lane_sums = lane_sums + halves[..., row, :]
        l = l * corr + _ascending(warp_sum(lane_sums))
        # each sub-chunk's bf16(p) @ v: one chain per output, keys in order
        p = p.to(torch.bfloat16).to(torch.float32)
        vb = vf[:, :, base:base + nsub * SUB_CHUNK].unflatten(2, (nsub, SUB_CHUNK))
        pv = torch.zeros((b, hk, g, nsub, d), device=dev)
        for r in range(min(SUB_CHUNK, kend - base)):
            pv.addcmul_(p[..., r, None], vb[:, :, None, :, r])
        acc = acc * corr[..., None] + _ascending(pv.movedim(3, -1))
        m = m_new
    return (acc / l[..., None]).reshape(b, h, d)


def _ascending(parts):
    """The partial sums of the last axis added in ascending order, as the
    cluster's CTA 0 adds its sub-chunks'."""
    total = parts[..., 0]
    for c in range(1, parts.shape[-1]):
        total = total + parts[..., c]
    return total


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.load("decode_attention").fp8q_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _no_bias(device):
    return torch.zeros(1, dtype=torch.int32, device=device)


def decode_attention(q, k_slab, v_slab, lengths, *, k_bias=None, v_bias=None,
                     kv_expo: Optional[int] = None, kv_mant: Optional[int] = None,
                     bs: int = 512):
    """K6: one-token attention over a cache slab, masked per slot.

    q: (B, H, D); k_slab, v_slab: (B, S, HK, D) bf16 grid values, or uint8
    ExMy codes (``kv_expo``/``kv_mant`` fields) with per-tensor int32
    packing biases ``k_bias``/``v_bias``; lengths: (B,) int32 valid keys per
    slot (decode over a cache of ``length`` tokens plus the one just written
    passes ``length + 1``); ``bs``: the key block (see :func:`block_size`).
    Returns (B, H, D) float32 (the TPU kernel's ``out_dtype`` has no caller
    here, so the kernel writes f32 only).
    ``decode_attention.launches`` counts kernel launches.
    """
    kw = dict(k_bias=k_bias, v_bias=v_bias, kv_expo=kv_expo, kv_mant=kv_mant, bs=bs)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_slab, v_slab, lengths, **kw)
    _check(q, k_slab, v_slab, lengths, k_bias, v_bias, kv_expo, kv_mant, bs)
    lens = torch.as_tensor(lengths)
    dev = _require_cuda("decode_attention", q, k_slab, v_slab, lens)
    coded = k_bias is not None
    if not coded and k_slab.dtype != torch.bfloat16:
        raise TypeError(f"the cache slab must be bfloat16 or uint8 codes, got {k_slab.dtype}")
    b, h, d = q.shape
    s, hk = k_slab.shape[1], k_slab.shape[2]
    if d > MAX_HEAD_DIM or d % 2 or h // hk > MAX_GROUP:
        raise ValueError(f"head dim {d} and {h // hk} query heads per kv head: the kernel "
                         f"takes an even head dim up to {MAX_HEAD_DIM} and up to {MAX_GROUP}")
    if -(-block_size(s, bs) // SUB_CHUNK) > MAX_SUB_CHUNKS:
        raise ValueError(f"the kernel's key block is at most {MAX_SUB_CHUNKS * SUB_CHUNK} "
                         f"keys, got bs={bs}")
    q32 = q.to(torch.float32).contiguous()
    k_slab, v_slab = k_slab.contiguous(), v_slab.contiguous()
    lens = lens.to(torch.int32).contiguous()
    if coded:
        kb, vb = (to_int32(x, dev).reshape(1).contiguous() for x in (k_bias, v_bias))
    else:
        kb = vb = _no_bias(dev)
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib()(q32.data_ptr(), k_slab.data_ptr(), v_slab.data_ptr(), out.data_ptr(),
                     lens.data_ptr(), b, h, s, hk, d, block_size(s, bs), int(coded),
                     kv_expo or 0, kv_mant or 0, kb.data_ptr(), vb.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
