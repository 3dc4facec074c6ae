"""Prefix caching: reuse prefilled KV across requests that share a prompt
prefix, port of ``models/prefix_cache.py``.

System prompts and few-shot headers repeat across requests, so their KV is
computed once, kept on the device and copied into a slot at admission; the
prefill then runs only over the remainder tokens with the slot's length
starting at the prefix length (the decoder's cache-attention path: the same
values a full prefill gives, since the KV at a position depends only on the
tokens up to it).

Prefixes are stored at bucket granularity (multiples of ``bucket``), so an
entry serves every prompt sharing at least that many leading tokens, and a
lookup picks the longest stored bucket that matches. Eviction is LRU on a
token budget.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

import torch


class PrefixCache:
    """Host-side LRU over on-device prefix KV slabs.

    Entries map ``tuple(prompt[:L])`` (L a bucket multiple) to ``(k, v)``
    tensors of shape (layers, 1, L, H_kv, D), the layout of a one-slot slice
    of the dense ``KVCache``, in the cache's dtype (bf16 or uint8 codes) and
    on its device. ``store`` copies them: the batcher's cache is written in
    place, so a view would change under later writes.
    """

    def __init__(self, max_tokens: int = 4096, bucket: int = 16,
                 max_entry_tokens: Optional[int] = None):
        """``max_entry_tokens`` caps how many leading tokens one entry may
        hold (default ``max_tokens // 4``), so that one long unique prompt
        cannot evict every shared system-prompt entry: only its head is
        stored."""
        self.max_tokens = max_tokens
        self.bucket = bucket
        if max_entry_tokens is None:
            max_entry_tokens = max(bucket, max_tokens // 4)
        self.max_entry_tokens = (max_entry_tokens // bucket) * bucket
        self._entries: "OrderedDict[Tuple[int, ...], Tuple[torch.Tensor, torch.Tensor]]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def cached_tokens(self) -> int:
        return sum(len(k) for k in self._entries)

    def lookup(self, prompt: List[int]) -> Optional[Tuple[int, torch.Tensor, torch.Tensor]]:
        """The longest usable shared prefix as (len, k, v), or None.

        An entry serves a prompt that shares any bucket-aligned leading run
        with it: the slabs are sliced to the shared length. Only proper
        prefixes are returned (len < len(prompt)), since admission needs at
        least one token to prefill for the next-token logits, and always
        bucket multiples: a full-prompt match drops a whole bucket."""
        best, best_key = 0, None
        for key in self._entries:
            j = 0
            for a, b in zip(key, prompt):
                if a != b:
                    break
                j += 1
            j = (j // self.bucket) * self.bucket
            if j >= len(prompt):
                j = ((len(prompt) - 1) // self.bucket) * self.bucket
            if j > best:
                best, best_key = j, key
        if best <= 0:
            self.misses += 1
            return None
        self._entries.move_to_end(best_key)
        self.hits += 1
        k, v = self._entries[best_key]
        return best, k[:, :, :best], v[:, :, :best]

    def store(self, prompt: List[int], k_slab, v_slab) -> int:
        """Cache a copy of the bucket-truncated prefix of ``prompt``; the
        slabs are (layers, 1, >=L, H_kv, D) slot slices. Returns the stored
        length (0 when the prompt is shorter than one bucket)."""
        lb = (len(prompt) // self.bucket) * self.bucket
        lb = min(lb, self.max_entry_tokens)
        if lb == 0:
            return 0
        key = tuple(prompt[:lb])
        if key in self._entries:
            self._entries.move_to_end(key)
            return lb
        self._entries[key] = (k_slab[:, :, :lb].clone(), v_slab[:, :, :lb].clone())
        while self.cached_tokens > self.max_tokens and len(self._entries) > 1:
            self._entries.popitem(last=False)
        return lb
