"""Small utilities: timing, seeding and the regularizers' cosine schedule
(port of ``utils/misc.py``).

The JAX package's ``approx_compiler_options`` raises XLA's scoped-VMEM
limit for approx conv models on a TPU; the port has no counterpart.
"""

from __future__ import annotations

import random
import time
from typing import Optional

import numpy as np
import torch


class Stopwatch:
    """Context-manager / start-stop timer."""

    def __init__(self, verbose: bool = False):
        self._start: Optional[float] = None
        self._elapsed = 0.0
        self.verbose = verbose

    def start(self):
        if self._start is None:
            self._start = time.perf_counter()
        return self

    def stop(self):
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None
        return self

    def reset(self):
        self._start = None
        self._elapsed = 0.0
        return self

    def get_total_duration(self) -> float:
        extra = time.perf_counter() - self._start if self._start is not None else 0.0
        return self._elapsed + extra

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        if self.verbose:
            print(f"elapsed: {self.get_total_duration():.4f}s")


def seed_all(seed: int) -> torch.Generator:
    """Seed Python's ``random``, numpy and torch (every device), and return
    a CPU ``torch.Generator`` seeded alike, where the JAX package returns
    its root key."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


class CosineTempDecay:
    """Cosine annealing schedule for regularizer weights: ``start_temp``
    until ``rel_decay_start * t_max``, then a cosine to ``end_temp`` at
    ``t_max``."""

    def __init__(self, t_max: int, temp_range=(20.0, 2.0), rel_decay_start: float = 0):
        self.t_max = t_max
        self.start_temp, self.end_temp = temp_range
        self.decay_start = rel_decay_start * t_max

    def __call__(self, t):
        if t < self.decay_start:
            return self.start_temp
        rel_t = (t - self.decay_start) / (self.t_max - self.decay_start)
        return self.end_temp + 0.5 * (self.start_temp - self.end_temp) * (
            1 + np.cos(rel_t * np.pi)
        )
