"""Paged FP8 KV cache and paged continuous batching for the Llama decoder,
port of ``models/paged_kv.py``.

* The KV store is one pool of ``num_pages`` pages of ``page_size`` tokens
  shared by every sequence: ``k_pages``/``v_pages`` are (L, N_pages,
  page_size, H_kv, D), bf16 FP8-grid values or uint8 codes under
  ``packed_kv``, as the dense ``KVCache`` holds them.
* Each slot owns a row of ``page_table`` (slots, max_pages), mapping its
  logical pages to pool pages. Page 0 is the trash page: idle slots and
  unallocated positions write there, so every step keeps one shape with no
  host branches, and only masked keys ever read it.
* A forward scatters its chunk into the pool in place (``k_pages[layer,
  page, offset]``) and gathers each slot's logical view (``k_pages[layer]
  [page_table]``), position-indexed exactly like the dense slab, for the
  attention (``models/llama.py``).
* The host's ``PageAllocator`` hands pages out as sequences grow and takes
  them back when a slot retires, so the device holds the pages in use
  instead of ``slots x max_seq`` rows.

``PagedBatcher`` is ``serving.ContinuousBatcher`` over such a pool: the
same protocol, sampling, prefix cache and speculative round. The page
table and the lengths live on the host and ship with each forward.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..quant.sites import FIXED, QuantPhase
from .llama import LlamaSpec, page_slots
from .sampling import GREEDY, SamplingParams
from .serving import ContinuousBatcher, _pad_to_bucket


class PagedKVCache(NamedTuple):
    """Paged KV cache; layouts in the module docstring."""

    k_pages: torch.Tensor     # (L, N_pages, page, H_kv, D) bf16 | uint8
    v_pages: torch.Tensor     # (L, N_pages, page, H_kv, D) bf16 | uint8
    page_table: torch.Tensor  # (B, max_pages) int32; 0 = trash / unallocated
    length: torch.Tensor      # (B,) int32

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @classmethod
    def zeros(cls, spec: LlamaSpec, batch: int, num_pages: int, page_size: int,
              max_pages: Optional[int] = None, dtype=torch.bfloat16,
              device=None) -> "PagedKVCache":
        mp = max_pages or -(-spec.max_seq_len // page_size)
        shape = (spec.num_layers, num_pages, page_size, spec.num_kv_heads, spec.head_dim)
        return cls(k_pages=torch.zeros(shape, dtype=dtype, device=device),
                   v_pages=torch.zeros(shape, dtype=dtype, device=device),
                   page_table=torch.zeros((batch, mp), dtype=torch.int32, device=device),
                   length=torch.zeros((batch,), dtype=torch.int32, device=device))


class PageAllocator:
    """Host free-list over pool pages 1..N-1 (0 is the trash page).

    Pages go out from the front of the list. A released page goes back to
    the front (the JAX package appends it), so the next admission reuses a
    retired slot's pages before it touches a page no slot has written:
    the pages in use stay at the low end of the pool."""

    def __init__(self, num_pages: int):
        self.free: List[int] = list(range(1, num_pages))

    @property
    def num_free(self) -> int:
        return len(self.free)

    def alloc(self, n: int = 1) -> List[int]:
        if n <= 0:
            return []
        if n > len(self.free):
            raise RuntimeError(f"KV page pool exhausted: need {n}, have {len(self.free)}")
        out, self.free = self.free[:n], self.free[n:]
        return out

    def release(self, pages: List[int]) -> None:
        self.free[:0] = [p for p in pages if p != 0]


def _gather_slot_slabs(cache: PagedKVCache):
    """A one-slot cache's logical view as dense (L, 1, S_max, H_kv, D)
    copies: the layout ``PrefixCache`` stores, a dense batcher's slot slice,
    so entries serve either batcher."""
    layers, _, page, h, d = cache.k_pages.shape
    s_max = cache.page_table.shape[1] * page
    row = cache.page_table[0].to(torch.int64)
    k = cache.k_pages[:, row].reshape(layers, 1, s_max, h, d)
    v = cache.v_pages[:, row].reshape(layers, 1, s_max, h, d)
    return k, v


class PagedBatcher(ContinuousBatcher):
    """Continuous batching over a paged KV pool.

    The protocol of ``serving.ContinuousBatcher`` (admit -> step* ->
    retire), with the target's cache allocated page by page as sequences
    grow. ``num_pages`` includes the trash page.

    * A cold admission prefills the prompt's chunk over the slot's table
      row (a batch-1 ``PagedKVCache``, ``chunk_attention``).
    * A warm admission (``prefix_cache``) takes pages for the prefix and the
      padded remainder, scatters the cached prefix into them and prefills
      the remainder over the slot's gathered view from the prefix length;
      entries are stored from that view, in the dense layout.
    * A step runs every slot at one shape, the page table and lengths
      shipped from the host; idle slots write to the trash page.
    * With a draft, each step is the shared batched speculative round: the
      draft keeps a dense slab (it is small), the target's verify scatters
      into pages taken for the whole k+1 round before any device call, and
      the rollback only moves ``lengths``: rejected rows are dead data in
      the slot's own pages, which stay the slot's until :meth:`retire`.

    ``mesh``: as the dense batcher's; the pool stays on the mesh's first
    device (the JAX package shards its KV-head axis over ``model``).
    """

    def __init__(self, model, spec: LlamaSpec, *, slots: int = 4, num_pages: int = 64,
                 page_size: int = 16, max_seq: Optional[int] = None, eos_token: int = -1,
                 qp: QuantPhase = FIXED, mesh=None, sampling: SamplingParams = GREEDY,
                 seed: int = 0, prefix_cache=None, draft_model=None,
                 draft_spec: Optional[LlamaSpec] = None, spec_k: int = 4,
                 draft_qp: Optional[QuantPhase] = None):
        self.page_size = page_size
        self.num_pages = num_pages
        super().__init__(model, spec, slots=slots, max_seq=max_seq, eos_token=eos_token,
                         qp=qp, mesh=mesh, sampling=sampling, seed=seed,
                         prefix_cache=prefix_cache, draft_model=draft_model,
                         draft_spec=draft_spec, spec_k=spec_k, draft_qp=draft_qp)
        self.allocator = PageAllocator(num_pages)
        self.table = np.zeros((slots, -(-self.max_seq // page_size)), np.int32)
        self.lengths = np.zeros((slots,), np.int32)

    def _new_cache(self) -> PagedKVCache:
        """The pool; its table and lengths are rebuilt from the host's for
        each forward (``_cache``)."""
        return PagedKVCache.zeros(self.spec, self.slots, self.num_pages, self.page_size,
                                  -(-self.max_seq // self.page_size),
                                  dtype=torch.uint8 if self.model.packed_kv else torch.bfloat16,
                                  device=self.device)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - self.allocator.num_free

    # -- page bookkeeping ----------------------------------------------------

    def _ensure_pages(self, slot: int, upto_tokens: int) -> None:
        """Allocate pages so that ``slot`` holds ``upto_tokens`` tokens."""
        need = -(-upto_tokens // self.page_size)
        row = self.table[slot]
        have = int(np.count_nonzero(row))
        if need > len(row):
            raise RuntimeError(f"sequence exceeds max_seq ({self.max_seq})")
        if need > have:
            row[have:need] = self.allocator.alloc(need - have)

    def _cache(self, rows=slice(None)) -> PagedKVCache:
        """The pool with the host's table and lengths of ``rows``."""
        return self.cache._replace(
            page_table=torch.tensor(self.table[rows], device=self.device),
            length=torch.tensor(self.lengths[rows], device=self.device))

    # -- the target's side of the ContinuousBatcher protocol ----------------

    def _admit_target(self, slot: int, prompt: List[int], pref):
        lp = 0 if pref is None else pref[0]
        # pages for the prefix and the padded chunk the prefill writes
        self._ensure_pages(slot, lp + _pad_to_bucket(len(prompt) - lp))
        self.lengths[slot] = lp
        sub = self._cache(slice(slot, slot + 1))
        if pref is not None:
            # the cached prefix into the slot's pages, allocated just above
            pp, off = page_slots(sub.page_table, torch.arange(lp, device=self.device)[None],
                                 self.page_size)
            self.cache.k_pages[:, pp[0], off[0]] = pref[1][:, 0]
            self.cache.v_pages[:, pp[0], off[0]] = pref[2][:, 0]
        last = self._prefill(self.model, self.qp, sub, prompt[lp:],
                             chunk_attention=pref is None)
        if self.prefix_cache is not None:
            self.prefix_cache.store(prompt, *_gather_slot_slabs(sub))
        self.lengths[slot] = len(prompt)
        return last

    def _reserve(self, live: List[int], n: int) -> None:
        for s in live:
            self._ensure_pages(s, int(self.lengths[s]) + n)

    def _run_target(self, tokens):
        return self.model(tokens, self._cache(), self.qp)

    def _advance(self, advance, n: int) -> None:
        self.lengths += advance

    def _lengths(self) -> List[int]:
        return self.lengths.tolist()

    def retire(self, slot: int) -> List[int]:
        """Free a finished slot and its pages; returns its generated tokens."""
        self.allocator.release([int(p) for p in self.table[slot] if p])
        self.table[slot] = 0
        self.lengths[slot] = 0
        return super().retire(slot)
