"""Token sampling for the serving batcher: greedy, temperature, top-k and
top-p (nucleus), port of ``models/sampling.py``.

The masks are the JAX package's: top-k first, then top-p on the survivors,
``-inf`` outside the support. Greedy is ``argmax``, which takes the first
maximum as ``jnp.argmax`` does. Stochastic sampling draws from a
``torch.Generator`` instead of a PRNG key; the two give different numbers
from one seed, so only the distribution is shared with the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingParams(NamedTuple):
    """Static sampling configuration."""

    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => disabled
    top_p: float = 1.0         # 1 => disabled

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def filtered_logits(logits, params: SamplingParams):
    """Temperature-scaled logits with the top-k / top-p mask applied
    (``-inf`` outside the support). Requires ``temperature > 0``."""
    scaled = torch.as_tensor(logits).to(torch.float32) / params.temperature
    ninf = torch.tensor(-torch.inf, device=scaled.device)

    if params.top_k and params.top_k > 0:
        kth = torch.topk(scaled, params.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, ninf, scaled)

    if params.top_p < 1.0:
        # nucleus: keep the smallest prefix of the sorted distribution whose
        # mass reaches top_p (the first token always survives)
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < params.top_p
        # threshold logit = smallest kept logit per row
        thr = torch.where(keep_sorted, sorted_logits,
                          torch.tensor(torch.inf, device=scaled.device)).amin(dim=-1,
                                                                              keepdim=True)
        scaled = torch.where(scaled < thr, ninf, scaled)

    return scaled


def filtered_probs(logits, params: SamplingParams):
    """The normalized distribution sampling draws from: the softmax of
    :func:`filtered_logits`."""
    return torch.softmax(filtered_logits(logits, params), dim=-1)


def sample_tokens(logits, params: SamplingParams,
                  generator: Optional[torch.Generator] = None):
    """One token per row. logits: (B, V) -> (B,) int64 on their device;
    stochastic sampling draws from ``generator`` (on the logits' device)."""
    logits = torch.as_tensor(logits).to(torch.float32)
    if params.greedy:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling with temperature > 0 needs a torch.Generator")
    return torch.multinomial(filtered_probs(logits, params), 1,
                             generator=generator).reshape(-1)
