"""Batches for the eval driver (port of ``eval/data.py``): the ImageNet
directory loaders (PIL + numpy, imported at first use), the strided
mini-test sampler and the synthetic stand-in.

Validation preprocessing is the reference's: resize the shorter side to
``image_size + 24`` (bilinear), center-crop ``image_size``, normalize with
the ImageNet mean and std; training batches (calibration and BN
re-estimation) take a random resized crop and a horizontal flip. Integer
class folders map to their own index. Everything is numpy, so the port and
the JAX package see identical batches from the same files and seed.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def preprocess_val(img, image_size: int = 224) -> np.ndarray:
    """Resize(shorter side -> image_size+24) + center crop, NHWC float."""
    from PIL import Image

    img = img.convert("RGB")
    target = image_size + 24
    w, h = img.size
    if w < h:
        nw, nh = target, int(round(h * target / w))
    else:
        nw, nh = int(round(w * target / h)), target
    img = img.resize((nw, nh), Image.BILINEAR)
    left = (nw - image_size) // 2
    top = (nh - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def preprocess_train(img, image_size: int = 224, rng=None) -> np.ndarray:
    """RandomResizedCrop(scale 0.08-1.0, ratio 3/4-4/3) + horizontal flip —
    the reference train transform (imagenet_dataloaders.py:49-57) used for
    range-estimation batches."""
    from PIL import Image

    rng = rng or np.random.default_rng()
    img = img.convert("RGB")
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            img2 = img.crop((left, top, left + cw, top + ch))
            break
    else:
        img2 = img  # fallback: center-ish full image
    img2 = img2.resize((image_size, image_size), Image.BILINEAR)
    arr = np.asarray(img2, np.float32) / 255.0
    if rng.uniform() < 0.5:
        arr = arr[:, ::-1, :]
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def imagenet_train_batches(
    images_dir: str,
    batch_size: int,
    image_size: int = 224,
    max_batches: Optional[int] = None,
    seed: int = 10,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield shuffled train batches from ``<images_dir>/train`` (used for
    calibration; quantization/utils.py:74-115 feeds train batches)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    samples = _list_val_samples(os.path.join(images_dir, "train"))
    order = rng.permutation(len(samples))
    batch_x, batch_y = [], []
    produced = 0
    for idx in order:
        path, label = samples[idx]
        with Image.open(path) as img:
            batch_x.append(preprocess_train(img, image_size, rng))
        batch_y.append(label)
        if len(batch_x) == batch_size:
            yield np.stack(batch_x), np.asarray(batch_y, np.int32)
            produced += 1
            batch_x, batch_y = [], []
            if max_batches is not None and produced >= max_batches:
                return


def _list_val_samples(val_dir: str) -> List[Tuple[str, int]]:
    """(path, label) pairs; integer-named class dirs remap directly to their
    index (imagenet_dataloaders.py:110-130), otherwise sorted-name order."""
    classes = sorted(
        d for d in os.listdir(val_dir)
        if os.path.isdir(os.path.join(val_dir, d))
    )
    if all(c.isdigit() for c in classes):
        label_of = {c: int(c) for c in classes}
    else:
        label_of = {c: i for i, c in enumerate(classes)}
    samples = []
    for c in classes:
        cdir = os.path.join(val_dir, c)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(_IMG_EXTS):
                samples.append((os.path.join(cdir, fname), label_of[c]))
    return samples


def imagenet_val_batches(
    images_dir: str,
    batch_size: int,
    image_size: int = 224,
    max_batches: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (NHWC images, labels) from ``<images_dir>/val``."""
    from PIL import Image

    samples = _list_val_samples(os.path.join(images_dir, "val"))
    batch_x, batch_y = [], []
    produced = 0
    for path, label in samples:
        with Image.open(path) as img:
            batch_x.append(preprocess_val(img, image_size))
        batch_y.append(label)
        if len(batch_x) == batch_size:
            yield np.stack(batch_x), np.asarray(batch_y, np.int32)
            produced += 1
            batch_x, batch_y = [], []
            if max_batches is not None and produced >= max_batches:
                return
    if batch_x and (max_batches is None or produced < max_batches):
        yield np.stack(batch_x), np.asarray(batch_y, np.int32)




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
