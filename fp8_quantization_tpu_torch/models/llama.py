"""Quantized Llama-family decoder with an FP8 KV cache, port of
``models/llama.py``.

* every projection (q/k/v/o, gate/up/down, lm_head) is a ``QuantDense`` with
  the calibrate-then-freeze sites, FP8 or uniform (int8, w4a8);
* K and V pass through their own sites (``k_cache_quantizer``,
  ``v_cache_quantizer``) before they are cached, as bf16 values (exact for
  FP8 grids, rounded for uniform ones, as in the JAX package) or, with
  ``packed_kv`` (FP8 only), as 1-byte ExMy codes on the sites' packing
  biases;
* one call handles a prefill chunk (T tokens) or a decode step (T=1) over a
  ``KVCache`` of fixed-capacity slots with per-slot lengths, or over a
  ``paged_kv.PagedKVCache``: a shared pool of pages and a page table per
  slot.

In the serving phases with ``QuantPhase(fused_sdpa=True)`` the prefill
attention is the fused SDPA kernel (K7: the cold chunk, or the warm cache
slab with per-slot ``offsets``) and the dense decode attention the decode
kernel (K6, over bf16 or coded slabs); otherwise it is the einsum path
(``einsum_attention``). A paged decode takes the einsum path over the
slot's gathered view, as the JAX package dispatches it. Unlike the TPU
kernels, neither kernel has a size gate: both stream the key axis.

The cache is written in place: the JAX package threads the whole stacked
cache through every layer and donates its buffer, which the port does by
writing the chunk's rows into the caller's ``k``/``v`` tensors (or pages).
A call returns a cache holding those same tensors and a new ``length``. The
dense writes clamp their start as ``lax.dynamic_update_slice`` does, so that
the chunk fits the slab; paged writes past a slot's table go to the trash
page, as the JAX package's scatter drops them.

Module and parameter names are the flax ones (``embed``, ``layer_{i}``,
``attn_norm``, ``q_proj``, ``k_cache_quantizer``, ``mlp_norm``,
``final_norm``, ``lm_head``), so ``models.bridge`` carries the JAX variables
across by name. RoPE, GQA and RMSNorm follow Llama 3; norms and rotary stay
full precision.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import QMethod, QuantConfig, RangeMethod
from ..numerics.codec import pack_exmy, unpack_consts, unpack_exmy_bits
from ..ops.cuda import attention as k7
from ..ops.cuda import decode_attention as k6
from ..ops.layers import QuantDense
from ..parallel.ring_attention import ring_attention
from ..quant.sites import FIXED, QuantPhase, QuantSite, decoded


@dataclasses.dataclass(frozen=True)
class LlamaSpec:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    mlp_dim: int = 14336
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 8192

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# Meta-Llama-3-8B's config.json
LLAMA3_8B = LlamaSpec()
LLAMA_TINY = LlamaSpec(vocab_size=256, hidden_size=64, num_layers=2,
                       num_heads=4, num_kv_heads=2, mlp_dim=128,
                       max_seq_len=64)


class KVCache(NamedTuple):
    """Per-layer stacked KV cache: bf16 FP8-grid values, or uint8 packed
    ExMy codes when the model runs with ``packed_kv``."""

    k: torch.Tensor        # (L, B, S, H_kv, D) bf16 | uint8
    v: torch.Tensor        # (L, B, S, H_kv, D) bf16 | uint8
    length: torch.Tensor   # (B,) int32: tokens already cached per slot

    @classmethod
    def zeros(cls, spec: LlamaSpec, batch: int, max_seq: Optional[int] = None,
              dtype=torch.bfloat16, device=None) -> "KVCache":
        s = max_seq or spec.max_seq_len
        shape = (spec.num_layers, batch, s, spec.num_kv_heads, spec.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((batch,), dtype=torch.int32, device=device))


def _rms_norm(x, gamma, eps):
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)) * gamma


def _rope(x, positions, theta):
    """Rotary embedding; x: (B, T, H, D), positions: (B, T)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=x.device) / d))
    angles = positions[..., None].to(torch.float32) * inv_freq      # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def write_rows(slab, rows, length):
    """Write ``rows`` (B, T, ...) into ``slab`` (B, S, ...) at per-slot
    positions ``[length[b], length[b] + T)``, in place, with the start
    clamped to ``[0, S - T]`` as ``lax.dynamic_update_slice`` clamps it. One
    device scatter; no host sync."""
    b, t = rows.shape[:2]
    s = slab.shape[1]
    start = length.to(torch.int64).clamp(0, s - t)
    idx = (torch.arange(b, device=slab.device)[:, None] * s + start[:, None]
           + torch.arange(t, device=slab.device)[None, :])
    slab.view(b * s, *slab.shape[2:]).index_copy_(0, idx.reshape(-1),
                                                  rows.reshape(b * t, *rows.shape[2:]))


def page_slots(page_table, positions, page: int):
    """Physical (page, offset) of each position of a chunk: ``page_table``
    (B, max_pages) maps a slot's logical pages to pool pages, ``positions``
    (B, T) are absolute. A position past the table maps to the trash page 0,
    where the JAX package's out-of-range scatter writes nothing."""
    logical = torch.div(positions, page, rounding_mode="floor").to(torch.int64)
    max_pages = page_table.shape[1]
    pp = torch.take_along_dim(page_table.to(torch.int64), logical.clamp(max=max_pages - 1),
                              dim=1)
    return torch.where(logical < max_pages, pp, 0), positions % page


def einsum_attention(qg, kf, vf, positions, length):
    """Attention over a cache view in plain PyTorch: each query at
    ``positions`` (B, T) attends to the keys at or before it and below
    ``length + T``. qg: (B, T, K, G, D) grouped queries; kf/vf: (B, S, K, D)
    decoded keys/values, the dense slab or a slot's gathered pages. Masked
    keys get probability 0, so what they hold (finite) never shows.
    Returns the context (B, T, K * G * D)."""
    b, t, _, _, hd = qg.shape
    s_max = kf.shape[1]
    scores = torch.einsum("btkgd,bskd->btkgs", qg, kf) / _sqrt_f32(hd, qg.device)
    key_pos = torch.arange(s_max, device=qg.device)[None, :]            # (1, S)
    valid = key_pos[:, None, :] <= positions[..., None]                 # (B, T, S)
    valid = valid & (key_pos[:, None, :] < (length[:, None, None] + t))
    scores = torch.where(valid[:, :, None, None, :], scores,
                         torch.tensor(-1e30, device=qg.device))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("btkgs,bskd->btkgd", probs, vf)
    return ctx.reshape(b, t, -1)


class QuantLlamaBlock(nn.Module):
    """One decoder layer. ``packed_kv``: store K/V as 1-byte ExMy codes on
    the K/V sites' packing biases (half the footprint of bf16); needs fixed
    ranges, quantized activations and a signed byte-sized FP format."""

    def __init__(self, qc: QuantConfig, spec: LlamaSpec, *, ring_spec=None,
                 packed_kv: bool = False, generator=None, device=None):
        super().__init__()
        self.qc = qc
        self.spec = spec
        self.packed_kv = packed_kv
        # (mesh, seq_axis): a prefill chunk (T > 1) into an EMPTY cache
        # attends by ring attention over the mesh axis (T must divide by it)
        self.ring_spec = ring_spec
        s = spec
        hd = s.head_dim
        kw = dict(use_bias=False, generator=generator, device=device)
        self.attn_norm = nn.Parameter(torch.ones(s.hidden_size, device=device))
        self.q_proj = QuantDense(qc, s.hidden_size, s.num_heads * hd, **kw)
        self.k_proj = QuantDense(qc, s.hidden_size, s.num_kv_heads * hd, **kw)
        self.v_proj = QuantDense(qc, s.hidden_size, s.num_kv_heads * hd, **kw)
        self.k_cache_quantizer = QuantSite(qc.act_quantizer(), qc.act_range, device=device)
        self.v_cache_quantizer = QuantSite(qc.act_quantizer(), qc.act_range, device=device)
        self.o_proj = QuantDense(qc, s.num_heads * hd, s.hidden_size, **kw)
        self.mlp_norm = nn.Parameter(torch.ones(s.hidden_size, device=device))
        self.gate_proj = QuantDense(qc, s.hidden_size, s.mlp_dim, **kw)
        self.up_proj = QuantDense(qc, s.hidden_size, s.mlp_dim, **kw)
        self.down_proj = QuantDense(qc, s.mlp_dim, s.hidden_size, **kw)

    def _kv_format(self):
        """(expo, mant) of the packed KV codes, after the JAX package's
        checks that the codes can hold the sites' grids."""
        acfg = self.qc.act_quantizer()
        if acfg.method != QMethod.fp_quantizer:
            raise ValueError("packed_kv requires the FP quantizer")
        if (self.qc.act_range.method == RangeMethod.MSE
                and acfg.fp8.mse_include_mantissa_bits):
            # the MSE estimator could elect other mantissa bits for the k/v
            # sites than the static format the codes decode with
            raise ValueError("packed_kv needs a fixed mantissa format: disable "
                             "fp8.mse_include_mantissa_bits with the MSE estimator")
        if acfg.fp8.allow_unsigned:
            # the codec assumes the sign+E+M byte layout
            raise ValueError("packed_kv requires signed KV sites: disable "
                             "fp8.allow_unsigned")
        mant = int(acfg.fp8.mantissa_bits)
        expo = acfg.n_bits - 1 - mant
        if expo < 1 or 1 + expo + mant > 8:
            raise ValueError(f"packed_kv format E{expo}M{mant}+sign must fit one byte")
        return expo, mant

    def forward(self, x, k_cache, v_cache, layer_idx: int, positions, length,
                qp: QuantPhase = FIXED, page_table=None, chunk_attention: bool = False):
        """One decoder layer over a token chunk.

        x: (B, T, hidden); positions: (B, T) absolute positions of the chunk;
        length: (B,) cache fill before it. ``k_cache``/``v_cache`` are the
        full (L, B, S, H_kv, D) slabs, or with a ``page_table`` (B,
        max_pages) the (L, N_pages, page, H_kv, D) pools; this layer writes
        its rows of the chunk into slab or pool ``layer_idx`` in place.
        ``chunk_attention``: attend over the chunk's own K/V instead of the
        slab (valid for an empty cache, where it is value-identical).
        Returns the layer's output."""
        s = self.spec
        b, t, _ = x.shape
        hd = s.head_dim
        groups = s.num_heads // s.num_kv_heads
        if self.packed_kv:
            kv_expo, kv_mant = self._kv_format()

        h = _rms_norm(x, self.attn_norm, s.rms_eps)
        q, k, v = self.q_proj(h, qp), self.k_proj(h, qp), self.v_proj(h, qp)
        q, k, v = decoded(q), decoded(k), decoded(v)
        q = _rope(q.reshape(b, t, s.num_heads, hd), positions, s.rope_theta)
        k = _rope(k.reshape(b, t, s.num_kv_heads, hd), positions, s.rope_theta)
        v = v.reshape(b, t, s.num_kv_heads, hd)

        # FP8-quantize K/V before caching: their own sites, stored bf16
        # (exact for the grid) or as uint8 codes (packed_kv)
        kb = vb = None
        if qp.quant_a:
            k = self.k_cache_quantizer(k, qp)
            v = self.v_cache_quantizer(v, qp)
            if self.packed_kv:
                kb = self.k_cache_quantizer.fp_pack_bias()[0]
                vb = self.v_cache_quantizer.fp_pack_bias()[0]
        elif self.packed_kv:
            raise ValueError("packed_kv requires quantized activations")

        if self.packed_kv:
            def store(u, bb):
                return pack_exmy(u.to(torch.float32), kv_expo, kv_mant, bb, clip_of=True)

            def load(u, bb):
                eb, ss = unpack_consts(bb, kv_mant)
                return unpack_exmy_bits(u, kv_expo, kv_mant, eb, ss)
        else:
            def store(u, bb):
                return u.to(torch.bfloat16)

            def load(u, bb):
                return u.to(torch.float32)

        k_st, v_st = store(k, kb), store(v, vb)
        if page_table is None:
            write_rows(k_cache[layer_idx], k_st, length)
            write_rows(v_cache[layer_idx], v_st, length)

            def slab(cache):
                return cache[layer_idx]
        else:
            # scatter into the pool (the layer's pages are a view of it);
            # idle slots and unallocated positions all land on the trash
            # page 0, which only masked keys ever read
            page = k_cache.shape[2]
            pp, off = page_slots(page_table, positions, page)
            k_cache[layer_idx][pp, off] = k_st
            v_cache[layer_idx][pp, off] = v_st

            def slab(cache):
                # the slot's logical view, a gathered copy: (B, S, H_kv, D)
                return cache[layer_idx][page_table.to(torch.int64)].reshape(
                    b, -1, s.num_kv_heads, hd)

        fused = qp.fast and not qp.estimating and qp.fused_sdpa is True
        qg = q.reshape(b, t, s.num_kv_heads, groups, hd)
        if self.ring_spec is not None and t > 1:
            # ring prefill: exact sequence-parallel self-attention over the
            # chunk (K/V blocks rotate around the mesh axis; online
            # softmax); the cache prefix must be empty (length == 0)
            mesh, seq_axis = self.ring_spec
            ctx = ring_attention(q.to(torch.float32), k.to(torch.float32),
                                 v.to(torch.float32), mesh, seq_axis=seq_axis, causal=True)
            ctx = ctx.reshape(b, t, s.num_heads * hd)
        elif chunk_attention and t > 1:
            # empty-cache prefill: the chunk is the cache prefix; the store/
            # load round trip matches the cache readback bit for bit
            kf, vf = load(k_st, kb), load(v_st, vb)                      # (B, T, K, D)
            if fused:
                ctx = self._fused_ctx(qg, kf, vf, offsets=None)
            else:
                scores = torch.einsum("btkgd,bukd->btkgu", qg, kf) / _sqrt_f32(hd, x.device)
                causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
                scores = torch.where(causal[None, :, None, None, :], scores,
                                     torch.tensor(-1e30, device=x.device))
                probs = torch.softmax(scores, dim=-1)
                ctx = torch.einsum("btkgu,bukd->btkgd", probs, vf)
                ctx = ctx.reshape(b, t, s.num_heads * hd)
        elif fused and t > 1:
            # warm prefill over the cache slab: T new queries at positions
            # length[b] + i attend to keys [0, length[b] + i], the kernel's
            # per-slot causal offsets (the tail past them is masked)
            ctx = self._fused_ctx(qg, load(slab(k_cache), kb), load(slab(v_cache), vb),
                                  offsets=length)
        elif fused and t == 1 and page_table is None:
            dec_kw = (dict(k_bias=kb, v_bias=vb, kv_expo=kv_expo, kv_mant=kv_mant)
                      if self.packed_kv else {})
            ctx = k6.decode_attention(q[:, 0], k_cache[layer_idx], v_cache[layer_idx],
                                      length + 1, **dec_kw)
            ctx = ctx.reshape(b, 1, s.num_heads * hd)
        else:
            # attention over the cache prefix [0, length + t), GQA grouping
            ctx = einsum_attention(qg, load(slab(k_cache), kb), load(slab(v_cache), vb),
                                   positions, length)

        attn_out = self.o_proj(ctx, qp)
        x = x + decoded(attn_out).to(torch.float32)
        return self._mlp(x, qp)

    def _fused_ctx(self, qg, kf, vf, offsets):
        """Context through K7 (bf16 operands, f32 softmax). qg: (B, T, K, G,
        D) grouped queries; kf/vf: (B, S, K, D), the chunk or the slab. The
        head merge is a view and GQA is a head index inside the kernel."""
        s = self.spec
        b, t = qg.shape[0], qg.shape[1]
        hd = qg.shape[-1]
        ctx = k7.fused_sdpa(qg.reshape(b, t, s.num_heads, hd).to(torch.bfloat16),
                            kf.to(torch.bfloat16), vf.to(torch.bfloat16),
                            causal=True, offsets=offsets)
        return ctx.reshape(b, t, s.num_heads * hd)

    def _mlp(self, x, qp: QuantPhase):
        s = self.spec
        h = _rms_norm(x, self.mlp_norm, s.rms_eps)
        gate = self.gate_proj(h, qp)
        up = self.up_proj(h, qp)
        down = self.down_proj(F.silu(decoded(gate).to(torch.float32))
                              * decoded(up).to(torch.float32), qp)
        return x + decoded(down).to(torch.float32)


def _sqrt_f32(n: int, device):
    """``sqrt(n)`` in f32, the einsum path's divisor (the kernels multiply
    by ``1/sqrt(n)`` instead, which rounds differently)."""
    return torch.sqrt(torch.tensor(float(n), dtype=torch.float32, device=device))


class QuantizedLlama(nn.Module):
    """Llama decoder: one call handles prefill (T tokens) or decode (T=1).

    Weights are drawn from ``generator`` (flax's initializers: normal(0.02)
    embeddings, lecun-normal kernels, unit norm scales); load others through
    ``load_state_dict`` (``models.bridge`` carries JAX variables across).
    ``packed_kv`` (settable): the cache holds uint8 codes, build it with
    ``KVCache.zeros(..., dtype=torch.uint8)`` (or ``PagedKVCache.zeros``).
    ``ring_spec`` (settable): ``(mesh, seq_axis)`` for a ring-attention
    prefill; call it only with an EMPTY cache and T divisible by the axis.
    """

    def __init__(self, qc: QuantConfig, spec: LlamaSpec = LLAMA_TINY, *, ring_spec=None,
                 packed_kv: bool = False, generator=None, device=None):
        super().__init__()
        self.qc = qc
        self.spec = spec
        s = spec
        embed = torch.empty(s.vocab_size, s.hidden_size, device=device)
        self.embed = nn.Parameter(nn.init.normal_(embed, 0.0, 0.02, generator=generator))
        for i in range(s.num_layers):
            setattr(self, f"layer_{i}", QuantLlamaBlock(qc, s, generator=generator,
                                                        device=device))
        self.final_norm = nn.Parameter(torch.ones(s.hidden_size, device=device))
        self.lm_head = QuantDense(qc, s.hidden_size, s.vocab_size, use_bias=False,
                                  quantize_output=False, generator=generator, device=device)
        self.packed_kv = packed_kv
        self.ring_spec = ring_spec

    @property
    def packed_kv(self) -> bool:
        return self._packed_kv

    @packed_kv.setter
    def packed_kv(self, value: bool):
        """Switch every block between the bf16 and the uint8 cache layout; the
        calibrated state is shared, not copied."""
        self._packed_kv = bool(value)
        for i in range(self.spec.num_layers):
            getattr(self, f"layer_{i}").packed_kv = self._packed_kv

    @property
    def ring_spec(self):
        return self._ring_spec

    @ring_spec.setter
    def ring_spec(self, value):
        """Switch every block between ring and single-device prefill."""
        self._ring_spec = value
        for i in range(self.spec.num_layers):
            getattr(self, f"layer_{i}").ring_spec = value

    def forward(self, tokens, cache, qp: QuantPhase = FIXED, chunk_attention: bool = False):
        """tokens: (B, T) integer ids appended after ``cache.length``;
        ``cache`` is a dense ``KVCache`` or a ``paged_kv.PagedKVCache``.
        Returns (logits (B, T, vocab), the cache of the same type with the
        chunk written in place and ``length + T``)."""
        page_table = getattr(cache, "page_table", None)
        if page_table is None:
            k_full, v_full = cache.k, cache.v
        else:
            k_full, v_full = cache.k_pages, cache.v_pages
            page_table = page_table.to(torch.int64)    # once, for every layer's indexing
        want = torch.uint8 if self.packed_kv else torch.bfloat16
        if k_full.dtype != want or v_full.dtype != want:
            raise TypeError(f"a {'packed_kv' if self.packed_kv else 'bf16'} model takes a "
                            f"{want} cache, got {k_full.dtype}")
        s = self.spec
        b, t = tokens.shape
        positions = cache.length[:, None] + torch.arange(t, device=tokens.device)[None, :]
        x = self.embed[tokens]
        for i in range(s.num_layers):
            x = getattr(self, f"layer_{i}")(x, k_full, v_full, i, positions, cache.length,
                                            qp, page_table, chunk_attention)
        x = _rms_norm(x, self.final_norm, s.rms_eps)
        logits = self.lm_head(x, qp)
        return decoded(logits), cache._replace(length=cache.length + t)
