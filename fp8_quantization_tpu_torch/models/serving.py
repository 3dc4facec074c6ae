"""Slot-based continuous batching for the quantized Llama decoder, port of
``models/serving.py`` (the cold-admission, non-speculative path).

A fixed-capacity batch of cache slots: a prompt is admitted into a free
slot by a right-padded prefill of its chunk alone (``chunk_attention``; the
pad tokens' K/V land past the prompt and decode overwrites them), every
decode step runs all slots at one fixed shape, and a finished sequence
retires its slot for the next admission. The cache lives on the model's
device and is written in place (the JAX package donates its buffer);
host-side bookkeeping touches only tokens and lengths.

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
from .sampling import GREEDY, SamplingParams, sample_tokens


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
    batcher takes the variables beside the model). Each call that samples
    draws from a ``torch.Generator`` derived from ``seed`` and a step count,
    as the JAX batcher folds its count into its key. The mesh-sharded,
    prefix-cached and speculative batchers belong to later slices and raise.
    """

    def __init__(self, model, spec: LlamaSpec, *, slots: int = 4,
                 max_seq: Optional[int] = None, eos_token: int = -1,
                 qp: QuantPhase = FIXED, mesh=None, sampling: SamplingParams = GREEDY,
                 seed: int = 0, prefix_cache=None, draft_model=None):
        if mesh is not None:
            raise NotImplementedError(f"mesh-sharded continuous batching {_LATER}")
        if prefix_cache is not None:
            raise NotImplementedError(f"prefix caching (prefix_cache) {_LATER}")
        if draft_model is not None:
            raise NotImplementedError(f"speculative decoding (draft_model) {_LATER}")
        self.model = model
        self.spec = spec
        self.slots = slots
        self.max_seq = max_seq or spec.max_seq_len
        self.eos_token = eos_token
        self.qp = qp
        self.sampling = sampling
        self.seed = seed
        self.device = _device(model)
        self.cache = KVCache.zeros(
            spec, slots, self.max_seq,
            dtype=torch.uint8 if model.packed_kv else torch.bfloat16, device=self.device)
        self.free: List[int] = list(range(slots))
        self.active: Dict[int, dict] = {}
        self._step_count = 0

    def _next_generator(self) -> Optional[torch.Generator]:
        """The generator of the next sampling call: a seed derived from
        (``seed``, step count), or None for greedy sampling, which draws
        nothing. The count advances either way, as in the JAX batcher."""
        self._step_count += 1
        if self.sampling.greedy:
            return None
        state = np.random.SeedSequence([self.seed, self._step_count]).generate_state(2)
        seed = (int(state[0]) << 32 | int(state[1])) & (2 ** 63 - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def admit(self, prompt: List[int], max_new_tokens: int = 32) -> int:
        """Prefill a prompt into a free slot; returns the slot id."""
        if not self.free:
            raise RuntimeError("no free slots")
        real = len(prompt)
        if _pad_to_bucket(real) > self.max_seq:
            raise ValueError(f"prompt of {real} tokens pads past max_seq={self.max_seq}")
        slot = self.free.pop(0)
        t_pad = _pad_to_bucket(real)
        tokens = np.zeros((1, t_pad), np.int64)
        tokens[0, :real] = prompt
        # the slot's slabs as a one-slot cache of length 0: the chunk's rows,
        # pad tokens included, land in the slot's [0, t_pad) in place
        sub = KVCache(k=self.cache.k[:, slot:slot + 1], v=self.cache.v[:, slot:slot + 1],
                      length=torch.zeros((1,), dtype=torch.int32, device=self.device))
        logits, _ = self.model(torch.from_numpy(tokens).to(self.device), sub, self.qp,
                               chunk_attention=True)
        first = int(sample_tokens(logits[:1, real - 1, :], self.sampling,
                                  self._next_generator())[0])
        self.cache.length[slot] = real
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
        slot -> token. Idle slots run too (one fixed shape) and write at
        their frozen length, which the ``keep`` mask does not advance."""
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

    def retire(self, slot: int) -> List[int]:
        """Free a finished slot; returns its generated tokens."""
        st = self.active.pop(slot)
        self.cache.length[slot] = 0
        self.free.append(slot)
        return st["generated"]

    def run_to_completion(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return
