"""Speculative decoding: draft-and-verify generation for the quantized Llama,
port of ``models/speculative.py``.

A small draft model proposes ``k`` tokens; the target verifies all of them
in one (k+1)-token forward and accepts the longest matching prefix plus its
own correction token, so each target forward yields 1 to k+1 tokens. Greedy
output stays exactly the target's greedy decode whatever the draft;
stochastic output is an exact sample of the target's ancestral sampling
(:func:`spec_accept`).

The draft's proposals are a loop of k+1 one-token decodes (the JAX package
scans them), the verify is one (k+1)-token forward over the cache slab (the
warm-prefill path: K7 with per-slot offsets under FAST+fused), and
rejection never rewrites cache contents: positions past the accepted
length are dead data under the ``length`` masking, overwritten by later
writes. Stochastic draws come from a ``torch.Generator``; the JAX package's
keys give other numbers, so only the laws are shared with it.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..parallel.shard_kernels import partitioned_kernels
from ..parallel.sharding import reshard
from ..quant.sites import FIXED, QuantPhase
from .llama import KVCache, LlamaSpec
from .sampling import GREEDY, SamplingParams, filtered_probs, sample_tokens, seeded_generator


def spec_accept(drafts, q_rows, p_rows, u, generator: Optional[torch.Generator] = None):
    """Stochastic speculative accept/reject (Leviathan et al. 2023, Chen et
    al. 2023), batched over any leading axes.

    drafts: (..., k) tokens sampled from the draft distributions ``q_rows``
    (..., k, V) (filtered and normalized); ``p_rows``: (..., k+1, V) target
    distributions at the same positions (row k is the bonus position after
    all drafts); ``u``: (..., k) uniforms; ``generator`` draws the residual.

    Draft i is accepted with probability min(1, p_i(x_i)/q_i(x_i)) given
    all earlier drafts accepted. At the first rejection m the replacement is
    drawn from the residual norm(max(p_m - q_m, 0)); with all k accepted the
    bonus token is drawn from p_k. The emitted prefix is then an exact
    sample of ancestral target sampling (per-token law q min(1, p/q) +
    (1 - alpha) norm((p - q)+) = p).

    Returns (out (..., k+1), m (...)): out[:m] the accepted drafts, out[m]
    the resampled or bonus token, out[m+1:] filler (copies of out[m])."""
    k = drafts.shape[-1]
    drafts = drafts.to(torch.int64)
    q_x = q_rows.gather(-1, drafts[..., None])[..., 0]
    p_x = p_rows[..., :k, :].gather(-1, drafts[..., None])[..., 0]
    acc = u < torch.clamp(p_x / q_x.clamp_min(1e-30), max=1.0)
    # m: the first rejection (k when every draft is accepted)
    m = torch.cat([acc, torch.zeros_like(acc[..., :1])], dim=-1).to(torch.int32).argmin(-1)
    p_m = p_rows.gather(-2, m[..., None, None].expand(*m.shape, 1, p_rows.shape[-1]))[..., 0, :]
    q_m = q_rows.gather(-2, m.clamp(max=k - 1)[..., None, None].expand(
        *m.shape, 1, q_rows.shape[-1]))[..., 0, :]
    resid = torch.where((m < k)[..., None], torch.clamp(p_m - q_m, min=0.0), p_m)
    norm = resid.sum(-1, keepdim=True)
    # a zero residual after a rejection has probability 0 (it needs p <= q
    # everywhere, which makes the acceptance ratio 1); fall back to p_m
    resid = torch.where(norm > 1e-30, resid / norm.clamp_min(1e-30), p_m)
    y = torch.multinomial(resid.reshape(-1, resid.shape[-1]), 1,
                          generator=generator).reshape(m.shape)
    filler = torch.cat([drafts, torch.zeros_like(drafts[..., :1])], dim=-1)
    out = torch.where(torch.arange(k + 1, device=drafts.device) < m[..., None], filler,
                      y[..., None])
    return out, m


def batched_spec_round(draft_model, d_cache, draft_qp, target_apply, tokens_cur, k,
                       sampling: SamplingParams, generator: Optional[torch.Generator] = None):
    """One batched speculative round: k+1 one-token draft decodes over all
    slots, then one (B, k+1)-token target verify with per-slot acceptance.

    ``target_apply``: ``tokens (B, k+1) -> (logits, target cache)``, the
    caller's closure over the target and its cache (rollback stays with the
    caller). Greedy sampling emits the longest matching prefix plus the
    target's correction; stochastic sampling runs :func:`spec_accept` per
    slot. The draft decodes k+1 times so that the last proposal's KV is
    written too (a fully accepted round would otherwise leave a zero row
    that later proposals attend).

    Returns ``(emitted (B, k+1), m (B,), t_cache, d_cache)``: slot b emits
    ``emitted[b, :m[b]+1]``; both caches come back with their lengths
    advanced by the k+1 writes."""
    stochastic = not sampling.greedy
    tok = tokens_cur.to(torch.int64)
    toks, q_rows = [], []
    for _ in range(k + 1):
        logits, d_cache = draft_model(tok[:, None], d_cache, draft_qp)
        row = logits[:, -1, :].to(torch.float32)
        if stochastic:
            q_row = filtered_probs(row, sampling)
            tok = torch.multinomial(q_row, 1, generator=generator)[:, 0]
            q_rows.append(q_row)
        else:
            tok = torch.argmax(row, dim=-1)
        toks.append(tok)
    drafts = torch.stack(toks[:k], dim=1)                              # (B, k)
    tokens = torch.cat([tokens_cur.to(torch.int64)[:, None], drafts], dim=1)
    logits, t_cache = target_apply(tokens)
    logits = logits.to(torch.float32)
    if stochastic:
        p_rows = filtered_probs(logits, sampling)                      # (B, k+1, V)
        u = torch.rand(drafts.shape, generator=generator, device=drafts.device)
        emitted, m = spec_accept(drafts, torch.stack(q_rows[:k], dim=1), p_rows, u, generator)
    else:
        greedy = torch.argmax(logits, dim=-1)                          # (B, k+1)
        match = drafts == greedy[:, :-1]
        m = torch.cat([match, torch.zeros_like(match[:, :1])], dim=1).to(torch.int32).argmin(1)
        corr = greedy.gather(1, m[:, None].to(torch.int64))
        filler = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        emitted = torch.where(torch.arange(k + 1, device=drafts.device)[None, :] < m[:, None],
                              filler, corr)
    return emitted, m, t_cache, d_cache


class SpecStats(NamedTuple):
    proposed: int       # draft tokens proposed
    accepted: int       # draft tokens accepted by the target
    target_steps: int   # target forwards executed

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)


class SpeculativeDecoder:
    """Speculative decoding of one sequence over (target, draft) quantized
    Llamas, each a ``QuantizedLlama`` holding its calibrated state.

    ``sampling=GREEDY`` (default): greedy draft and longest-matching-prefix
    verification, token-identical to the target's greedy decode. With
    ``temperature > 0``: stochastic proposals and :func:`spec_accept`,
    distributed as ancestral sampling from the target's filtered
    distribution. Both take packed (uint8) KV caches.

    ``mesh``: an optional (data, model) ``parallel.sharding.Mesh`` whose
    first device holds both models: their weights are placed by
    ``reshard`` and every forward runs under
    ``partitioned_kernels``, so packed and int4 weights run their kernels
    per shard (the convenience the ``ContinuousBatcher`` offers)."""

    def __init__(self, model, spec: LlamaSpec, draft_model, draft_spec: LlamaSpec, *,
                 k: int = 4, max_seq: Optional[int] = None, qp: QuantPhase = FIXED,
                 draft_qp: Optional[QuantPhase] = None, eos_token: int = -1,
                 sampling: SamplingParams = GREEDY, seed: int = 0, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            reshard(model, mesh)
            reshard(draft_model, mesh)
        self.model, self.spec = model, spec
        self.draft, self.draft_spec = draft_model, draft_spec
        self.k = k
        self.max_seq = max_seq or min(spec.max_seq_len, draft_spec.max_seq_len)
        self.qp = qp
        self.draft_qp = draft_qp or qp
        self.eos_token = eos_token
        self.sampling = sampling
        self.seed = seed
        self.device = next(model.parameters()).device
        self._count = 0

    def _next_generator(self) -> Optional[torch.Generator]:
        self._count += 1
        if self.sampling.greedy:
            return None
        return seeded_generator(self.seed, self._count, self.device)

    @torch.no_grad()
    def _prefill(self, model, spec, qp, prompt):
        """Right-padded prefill of ``prompt`` (to a multiple of 8) into a
        fresh one-slot cache; the padded positions are dead data past the
        length. Returns the last prompt token's logits row (1, V) and the
        cache."""
        real = len(prompt)
        t_pad = max(8, -(-real // 8) * 8)
        cache = KVCache.zeros(spec, 1, self.max_seq,
                              dtype=torch.uint8 if model.packed_kv else torch.bfloat16,
                              device=self.device)
        tokens = torch.zeros((1, t_pad), dtype=torch.int64, device=self.device)
        tokens[0, :real] = torch.tensor(prompt, dtype=torch.int64, device=self.device)
        logits, cache = model(tokens, cache, qp, chunk_attention=True)
        return logits[:1, real - 1], cache._replace(length=torch.full_like(cache.length, real))

    @torch.no_grad()
    def generate(self, prompt: List[int], max_new_tokens: int = 32
                 ) -> Tuple[List[int], SpecStats]:
        """Decode ``max_new_tokens`` tokens after ``prompt``; returns (tokens,
        stats). Greedy: exactly the target's own greedy continuation.
        Stochastic: an exact sample of the target's ancestral sampling,
        whatever the draft."""
        ctx = (partitioned_kernels(self.mesh) if self.mesh is not None
               else contextlib.nullcontext())
        with ctx:
            return self._generate(prompt, max_new_tokens)

    def _generate(self, prompt: List[int], max_new_tokens: int) -> Tuple[List[int], SpecStats]:
        row, t_cache = self._prefill(self.model, self.spec, self.qp, prompt)
        t_cur = sample_tokens(row, self.sampling, self._next_generator())
        _, d_cache = self._prefill(self.draft, self.draft_spec, self.draft_qp, prompt)
        p = len(prompt)
        out: List[int] = [int(t_cur[0])]
        proposed = accepted = steps = 0
        while (len(out) < max_new_tokens and out[-1] != self.eos_token
               and p + len(out) + self.k + 1 < self.max_seq):
            emitted, m, t_cache, d_cache = batched_spec_round(
                self.draft, d_cache, self.draft_qp,
                lambda toks, c=t_cache: self.model(toks, c, self.qp),
                t_cur, self.k, self.sampling, self._next_generator())
            m = int(m[0])
            steps += 1
            proposed += self.k
            accepted += m
            for tok in emitted[0, :m + 1].tolist():
                out.append(tok)
                if tok == self.eos_token or len(out) >= max_new_tokens:
                    break
            # both caches hold exactly prompt + out[:-1]; the head token
            # out[-1] is fed next, and rejected positions are dead data
            valid = torch.full_like(t_cache.length, p + len(out) - 1)
            t_cache, d_cache = t_cache._replace(length=valid), d_cache._replace(length=valid)
            t_cur = torch.tensor([out[-1]], dtype=torch.int64, device=self.device)
        return out[:max_new_tokens], SpecStats(proposed, accepted, steps)
