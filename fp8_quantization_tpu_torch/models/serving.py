"""Slot-based continuous batching for the quantized Llama decoder, port of
``models/serving.py``.

A fixed-capacity batch of cache slots: a prompt is admitted into a free
slot by a right-padded prefill of its chunk alone (``chunk_attention``; the
pad tokens' K/V land past the prompt and decode overwrites them), every
decode step runs all slots at one fixed shape, and a finished sequence
retires its slot for the next admission. The cache lives on the model's
device and is written in place (the JAX package donates its buffer);
host-side bookkeeping touches only tokens and lengths.

With a ``PrefixCache`` an admission splices the longest cached prefix's K/V
into the slot and prefills only the remainder over the slab (the warm
route: K7 with per-slot offsets under FAST+fused). With a draft model every
step is a batched speculative round (``models/speculative.py``): k+1 draft
decodes and one (slots, k+1)-token target verify, each slot advancing by 1
to k+1 tokens with a per-slot rollback of both caches' lengths. The draft
is always prefilled cold over the full prompt. The mesh-sharded batcher
belongs to a later slice and raises.

``calibrate_llama`` then ``pack_llama`` are the calibrate-then-serve
sequence of ``scripts/bench_llama.py`` and ``scripts/bench_llama_big.py``:
an ESTIMATE forward on a calibration batch and a FAST ``cache_weights``
forward, then for the packed phases the weight codes with the f32 kernels
and weight caches dropped.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import LATER as _LATER
from ..config import QMethod
from ..quant.sites import ESTIMATE, FIXED, QuantPhase
from .llama import KVCache, LlamaSpec
from .sampling import GREEDY, SamplingParams, sample_tokens, seeded_generator
from .speculative import batched_spec_round


def _pad_to_bucket(n: int, bucket: int = 16) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def _device(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def calibrate_llama(model, calib_tokens):
    """Calibrate ``model`` in place and make it ready to serve the FAST
    phases: an ``ESTIMATE`` forward of ``calib_tokens`` (B, T), then a fast
    ``cache_weights`` forward that stores every projection's quantized
    weights (bf16 for the FP quantizer, f32 for the uniform ones, whose
    grids bf16 does not hold).
    Each forward writes a fresh zero cache of 64 slots per row (at least T),
    as ``scripts/bench_llama.py`` calibrates."""
    dev = _device(model)
    tokens = torch.as_tensor(np.asarray(calib_tokens), dtype=torch.int64, device=dev)
    kv = torch.uint8 if model.packed_kv else torch.bfloat16

    def cache():
        return KVCache.zeros(model.spec, tokens.shape[0], max(64, tokens.shape[1]), dtype=kv,
                             device=dev)

    model(tokens, cache(), ESTIMATE)
    model(tokens, cache(), QuantPhase(phase="fixed", fast=True, cache_weights=True))


def pack_llama(model):
    """Switch a calibrated ``model`` to the PACKED phases in place: weight
    codes (``pack_dense_caches``: 1-byte ExMy codes for the FP quantizer,
    int8 or nibble-packed int4 codes for the uniform ones), the f32 kernels
    and weight caches dropped (``strip_packed_params``) and, where the act
    quantizer is FP, a uint8 KV cache (``packed_kv``). Uniform act grids
    keep the bf16 cache, as the JAX package serves them
    (``scripts/bench_llama.py``): ``packed_kv`` needs an ExMy grid.
    Returns the packing report (layer -> bit-exact channel fraction)."""
    from ..ops.fastpath import pack_dense_caches, strip_packed_params

    _, report = pack_dense_caches(model, model.qc)
    strip_packed_params(model)
    model.packed_kv = model.qc.act_quantizer().method == QMethod.fp_quantizer
    return report


class ContinuousBatcher:
    """Continuous batching over a fixed slot capacity.

    ``model`` is a ``QuantizedLlama`` holding its calibrated state (the JAX
    batcher takes the variables beside the model), and so is
    ``draft_model``. Each call that samples draws from a ``torch.Generator``
    derived from ``seed`` and a step count, as the JAX batcher folds its
    count into its key.

    ``prefix_cache``: an optional ``PrefixCache``; shared prompt prefixes
    are prefilled once and later admissions copy their K/V (see
    :meth:`admit`). ``draft_model``/``draft_spec``/``spec_k``/``draft_qp``:
    an optional draft for batched speculative decoding (see :meth:`step`).
    Greedy output stays token-identical to the non-speculative batcher's;
    stochastic output keeps :func:`~.speculative.spec_accept`'s exact
    target law per slot. Both compose with each other and with packed
    (uint8) KV on either model.
    """

    def __init__(self, model, spec: LlamaSpec, *, slots: int = 4,
                 max_seq: Optional[int] = None, eos_token: int = -1,
                 qp: QuantPhase = FIXED, mesh=None, sampling: SamplingParams = GREEDY,
                 seed: int = 0, prefix_cache=None, draft_model=None,
                 draft_spec: Optional[LlamaSpec] = None, spec_k: int = 4,
                 draft_qp: Optional[QuantPhase] = None):
        if mesh is not None:
            raise NotImplementedError(f"mesh-sharded continuous batching {_LATER}")
        self.model = model
        self.spec = spec
        self.slots = slots
        self.max_seq = max_seq or spec.max_seq_len
        self.eos_token = eos_token
        self.qp = qp
        self.sampling = sampling
        self.seed = seed
        self.prefix_cache = prefix_cache
        self.draft = draft_model
        self.draft_spec = draft_spec
        self.draft_qp = draft_qp or qp
        self.spec_k = spec_k
        self.proposed = 0   # speculative telemetry (SpecStats)
        self.accepted = 0
        self.device = _device(model)
        self.cache = self._slot_cache(model, spec)
        self.draft_cache = (self._slot_cache(draft_model, draft_spec)
                            if draft_model is not None else None)
        self.free: List[int] = list(range(slots))
        self.active: Dict[int, dict] = {}
        self._step_count = 0

    def _slot_cache(self, model, spec) -> KVCache:
        return KVCache.zeros(spec, self.slots, self.max_seq,
                             dtype=torch.uint8 if model.packed_kv else torch.bfloat16,
                             device=self.device)

    def _next_generator(self) -> Optional[torch.Generator]:
        """The generator of the next sampling call: a seed derived from
        (``seed``, step count), or None for greedy sampling, which draws
        nothing. The count advances either way, as in the JAX batcher."""
        self._step_count += 1
        if self.sampling.greedy:
            return None
        return seeded_generator(self.seed, self._step_count, self.device)

    def _slot(self, cache: KVCache, slot: int, length: int) -> KVCache:
        """The slot's slabs as a one-slot cache of ``length``: a forward
        writes its rows into the slot in place."""
        return KVCache(k=cache.k[:, slot:slot + 1], v=cache.v[:, slot:slot + 1],
                       length=torch.full((1,), length, dtype=torch.int32, device=self.device))

    def _prefill(self, model, qp, sub: KVCache, tokens: List[int], chunk_attention: bool):
        """Right-padded prefill of ``tokens`` into the one-slot cache ``sub``;
        returns the logits row of the last real token, (1, V)."""
        t_pad = _pad_to_bucket(len(tokens))
        padded = np.zeros((1, t_pad), np.int64)
        padded[0, :len(tokens)] = tokens
        logits, _ = model(torch.from_numpy(padded).to(self.device), sub, qp,
                          chunk_attention=chunk_attention)
        return logits[:1, len(tokens) - 1, :]

    @torch.no_grad()
    def admit(self, prompt: List[int], max_new_tokens: int = 32) -> int:
        """Prefill a prompt into a free slot; returns the slot id.

        With a ``prefix_cache``, the longest cached prefix's K/V is copied
        into the slot and only the remainder is prefilled, over the slab
        from the prefix length (the same values: prefix K/V depend only on
        the prefix tokens). A padded remainder that would run past
        ``max_seq`` takes the cold path: the write's start clamp would put
        pad rows over the end of the prefix. Every admission then stores
        its prompt's prefix. A draft is always prefilled cold over the
        whole prompt: the prefix cache holds the target's K/V only."""
        if not self.free:
            raise RuntimeError("no free slots")
        real = len(prompt)
        if _pad_to_bucket(real) > self.max_seq:
            raise ValueError(f"prompt of {real} tokens pads past max_seq={self.max_seq}")
        slot = self.free.pop(0)

        pref = self.prefix_cache.lookup(prompt) if self.prefix_cache is not None else None
        if pref is not None and pref[0] + _pad_to_bucket(real - pref[0]) > self.max_seq:
            pref = None
        if pref is not None:
            lp, k_pref, v_pref = pref
            self.cache.k[:, slot:slot + 1, :lp] = k_pref
            self.cache.v[:, slot:slot + 1, :lp] = v_pref
            row = self._prefill(self.model, self.qp, self._slot(self.cache, slot, lp),
                                prompt[lp:], chunk_attention=False)
        else:
            row = self._prefill(self.model, self.qp, self._slot(self.cache, slot, 0), prompt,
                                chunk_attention=True)
        first = int(sample_tokens(row, self.sampling, self._next_generator())[0])
        if self.prefix_cache is not None:
            self.prefix_cache.store(prompt, self.cache.k[:, slot:slot + 1],
                                    self.cache.v[:, slot:slot + 1])
        self.cache.length[slot] = real
        if self.draft is not None:
            # the draft's cache holds prompt + generated[:-1], as the target's
            self._prefill(self.draft, self.draft_qp, self._slot(self.draft_cache, slot, 0),
                          prompt, chunk_attention=True)
            self.draft_cache.length[slot] = real
        self.active[slot] = {
            "generated": [first],
            "remaining": max_new_tokens - 1,
            "plen": real,
            "done": first == self.eos_token or max_new_tokens <= 1,
        }
        return slot

    @torch.no_grad()
    def step(self) -> Dict[int, int]:
        """One batched decode step for every active unfinished slot; returns
        slot -> token (with a draft, the last token each slot emitted).
        Idle slots run too (one fixed shape) and write at their frozen
        length, which the ``keep`` mask does not advance.

        With a draft model this is a batched speculative round: each live
        slot advances by 1 to ``spec_k`` + 1 tokens. Slots whose cache
        cannot hold a whole round finish early, within ``spec_k`` + 1 tokens
        of ``max_seq`` (the non-speculative step cuts at ``max_seq`` - 1)."""
        if self.draft is not None:
            return self._step_speculative()
        live = [s for s, st in self.active.items() if not st["done"]]
        if not live:
            return {}
        tokens = np.zeros((self.slots, 1), np.int64)
        for s in live:
            tokens[s, 0] = self.active[s]["generated"][-1]
        keep = np.zeros((self.slots,), bool)
        keep[live] = True
        logits, new = self.model(torch.from_numpy(tokens).to(self.device), self.cache, self.qp)
        keep_t = torch.from_numpy(keep).to(self.device)
        self.cache = new._replace(length=torch.where(keep_t, new.length, new.length - 1))
        nt = sample_tokens(logits[:, -1, :], self.sampling, self._next_generator()).tolist()
        lengths = self.cache.length.tolist()

        out: Dict[int, int] = {}
        for s in live:
            tok = int(nt[s])
            st = self.active[s]
            st["generated"].append(tok)
            st["remaining"] -= 1
            out[s] = tok
            if (tok == self.eos_token or st["remaining"] <= 0
                    or lengths[s] >= self.max_seq - 1):
                st["done"] = True
        return out

    def _step_speculative(self) -> Dict[int, int]:
        """One batched speculative round (see :meth:`step`)."""
        k = self.spec_k
        live = []
        for s, st in self.active.items():
            if st["done"]:
                continue
            if st["plen"] + len(st["generated"]) + k + 1 > self.max_seq:
                # no room for a whole k+1-token round in the slab
                st["done"] = True
                continue
            live.append(s)
        if not live:
            return {}
        tokens = np.zeros((self.slots,), np.int64)
        for s in live:
            tokens[s] = self.active[s]["generated"][-1]
        keep = np.zeros((self.slots,), bool)
        keep[live] = True

        emitted, m, t_cache, d_cache = batched_spec_round(
            self.draft, self.draft_cache, self.draft_qp,
            lambda toks: self.model(toks, self.cache, self.qp),
            torch.from_numpy(tokens).to(self.device), k, self.sampling,
            self._next_generator())
        # per-slot rollback: live slots advance to their accepted frontier
        # (m + 1 of the k + 1 writes), idle slots undo them all; positions
        # past the length are dead data, as an idle slot's decode writes
        advance = torch.where(torch.from_numpy(keep).to(self.device), m.to(torch.int32) + 1, 0)
        self.cache = t_cache._replace(length=t_cache.length - (k + 1) + advance)
        self.draft_cache = d_cache._replace(length=d_cache.length - (k + 1) + advance)
        em, mm = emitted.tolist(), m.tolist()

        out: Dict[int, int] = {}
        for s in live:
            st = self.active[s]
            acc = mm[s]
            self.proposed += k
            self.accepted += acc
            for tok in em[s][:acc + 1]:
                st["generated"].append(tok)
                st["remaining"] -= 1
                out[s] = tok
                if tok == self.eos_token or st["remaining"] <= 0:
                    # cut mid-round: the slot is done, so the cache past the
                    # kept tokens is dead data
                    st["done"] = True
                    break
        return out

    @property
    def acceptance_rate(self) -> float:
        """Draft-token acceptance across all speculative rounds so far."""
        return self.accepted / max(self.proposed, 1)

    def retire(self, slot: int) -> List[int]:
        """Free a finished slot; returns its generated tokens."""
        st = self.active.pop(slot)
        self.cache.length[slot] = 0
        if self.draft_cache is not None:
            self.draft_cache.length[slot] = 0
        self.free.append(slot)
        return st["generated"]

    def run_to_completion(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return
