"""Batches for the eval driver (port of ``eval/data.py``: the synthetic
stand-in and the strided mini-test sampler; the ImageNet directory loaders
belong to a later slice).

Both are numpy, so the port and the JAX package see identical data from the
same seed.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def strided_batches(batches, num_batches: int, start_index: int, step: int):
    """Mini-test sampling: every ``step``-th batch from ``start_index``,
    ``num_batches`` total."""
    picked = 0
    for i, b in enumerate(batches):
        if i >= start_index and (i - start_index) % step == 0:
            yield b
            picked += 1
            if picked >= num_batches:
                return


def synthetic_batches(
    batch_size: int,
    num_batches: int,
    image_size: int = 224,
    num_classes: int = 1000,
    seed: int = 10,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic synthetic NHWC images and int labels."""
    rng = np.random.default_rng(seed)
    for _ in range(num_batches):
        x = rng.normal(size=(batch_size, image_size, image_size, 3)).astype(
            np.float32
        )
        y = rng.integers(0, num_classes, size=(batch_size,), dtype=np.int32)
        yield x, y
