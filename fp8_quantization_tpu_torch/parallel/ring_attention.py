"""Ring attention: sequence-parallel exact attention over a device mesh, port
of ``parallel/ring_attention.py``.

Q, K and V are split over the sequence axis of a :class:`~.sharding.Mesh`.
Each shard keeps its Q block on its device while the K/V blocks rotate
around the ring (one ``.to()`` of each block to the next shard's device a
step), and the blockwise online softmax (m, l, acc) of FlashAttention /
Ring Attention accumulates the exact result. The JAX body is einsums under
``shard_map`` with a ``ppermute`` ring and no Pallas kernel, so plain
PyTorch einsums are its faithful port. The result is independent of the
device count up to float reassociation.
"""

from __future__ import annotations

from typing import Optional

import torch

from .sharding import Mesh

_NEG = -1e30  # finite stand-in for -inf: keeps the online-softmax exp finite


def _ring_devices(mesh: Mesh, seq_axis: str):
    """The devices around the ring: the cells along ``seq_axis`` at index 0
    of the other axis (the JAX program repeats the ring on every index of
    the other axis, all with the same result)."""
    n = mesh.shape[seq_axis]
    if seq_axis == "data":
        return [mesh.devices[i, 0] for i in range(n)]
    return [mesh.devices[0, i] for i in range(n)]


def _block_step(q, k_blk, v_blk, m, l, acc, *, q_pos, src: int, causal: bool, scale: float):
    """One ring step of one shard: fold the K/V block of global block index
    ``src`` into the running (m, l, acc). q: (B, Tq, H, D)."""
    tk = k_blk.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
    if causal:
        k_pos = src * tk + torch.arange(tk, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]                       # (Tq, Tk)
        scores = torch.where(mask[None, None], scores,
                             torch.tensor(_NEG, dtype=scores.dtype, device=q.device))
    m_new = torch.maximum(m, torch.amax(scores, dim=-1))               # (B, H, Tq)
    p = torch.exp(scores - m_new[..., None])
    if causal:
        p = torch.where(mask[None, None], p, torch.zeros((), dtype=p.dtype, device=q.device))
    corr = torch.exp(m - m_new)
    l = l * corr + torch.sum(p, dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
    return m_new, l, acc


def ring_attention(q, k, v, mesh: Mesh, *, seq_axis: str = "data", causal: bool = True,
                   scale: Optional[float] = None):
    """Exact attention with sequence-sharded inputs.

    q: (B, S, H, D); k/v: (B, S, H_kv, D) with H_kv dividing H (GQA kv
    heads are repeated). S must divide by the mesh axis size. Returns (B, S,
    H, D) in q's dtype, gathered on q's device."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    if h % h_kv:
        raise ValueError(f"num_heads {h} not a multiple of kv heads {h_kv}")
    if h_kv != h:
        k = torch.repeat_interleave(k, h // h_kv, dim=2)
        v = torch.repeat_interleave(v, h // h_kv, dim=2)
    n = mesh.shape[seq_axis]
    if s % n:
        raise ValueError(f"sequence {s} not divisible by mesh axis size {n}")
    scale = scale if scale is not None else d ** -0.5
    devs = _ring_devices(mesh, seq_axis)
    blk = s // n

    qs = [q[:, i * blk:(i + 1) * blk].to(devs[i]) for i in range(n)]
    ks = [k[:, i * blk:(i + 1) * blk].to(devs[i]) for i in range(n)]
    vs = [v[:, i * blk:(i + 1) * blk].to(devs[i]) for i in range(n)]
    state = [(torch.full((b, h, blk), _NEG, dtype=torch.float32, device=dev),
              torch.zeros((b, h, blk), dtype=torch.float32, device=dev),
              torch.zeros((b, h, blk, d), dtype=torch.float32, device=dev)) for dev in devs]
    q_pos = [i * blk + torch.arange(blk, device=devs[i]) for i in range(n)]
    for step in range(n):
        for i in range(n):
            state[i] = _block_step(qs[i], ks[i], vs[i], *state[i], q_pos=q_pos[i],
                                   src=(i - step) % n, causal=causal, scale=scale)
        # rotate: the block shard i holds moves to shard i + 1
        ks = [ks[(i - 1) % n].to(devs[i]) for i in range(n)]
        vs = [vs[(i - 1) % n].to(devs[i]) for i in range(n)]

    outs = []
    for (_, l, acc) in state:
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype).to(q.device))
    return torch.cat(outs, dim=1)


def full_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None):
    """Single-device reference: plain softmax attention, same conventions."""
    d = q.shape[-1]
    h, h_kv = q.shape[2], k.shape[2]
    if h_kv != h:
        k = torch.repeat_interleave(k, h // h_kv, dim=2)
        v = torch.repeat_interleave(v, h // h_kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (scale if scale is not None else d ** -0.5)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        scores = torch.where(mask[None, None], scores,
                             torch.tensor(_NEG, dtype=scores.dtype, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", probs, v)
    return out.permute(0, 2, 1, 3).to(q.dtype)
