"""Small utilities: timing and seeding (port of ``utils/misc.py``).

The JAX package's ``approx_compiler_options`` raises XLA's scoped-VMEM
limit for approx conv models on a TPU; the port has no counterpart.
``CosineTempDecay`` goes with QAT.
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
