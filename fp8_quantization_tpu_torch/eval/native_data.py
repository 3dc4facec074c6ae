"""The native (C++ thread pool) image pipeline (port of
``eval/native_data.py``), over ``runtime/image_loader.cc``.

The library decodes JPEG / PNG (libjpeg, libpng) and runs the validation
preprocess (a PIL-style triangle resize, the center crop, the ImageNet
normalization of ``eval.data.preprocess_val``) for a whole batch in C++
threads. It is built at first use with the local ``g++ ... -ljpeg -lpng``
into ``fp8_quantization_tpu_torch/build/``, under a name carrying a digest of
the source and the flags, as ``utils.native`` builds the codec; where it
cannot be built, :func:`available` is False and callers take the PIL
pipeline. Nothing fails at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .data import IMAGENET_MEAN, IMAGENET_STD, _list_val_samples

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "runtime", "image_loader.cc")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-ljpeg", "-lpng")

_lib = None
# why the last build or load failed (the compiler's or the loader's
# message), or None
build_error: Optional[str] = None


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR, f"libimage_loader_{h.hexdigest()[:12]}.so")


def _build(path: str) -> bool:
    global build_error
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None or not os.path.exists(SOURCE):
        build_error = "no g++" if cxx is None else f"no {SOURCE}"
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, path)          # atomic: a concurrent loader sees all or nothing
    except subprocess.CalledProcessError as e:
        build_error = (e.stderr or "").strip()[-2000:] or str(e)
        return False
    except (OSError, subprocess.SubprocessError) as e:
        build_error = str(e)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return True


def load() -> Optional[ctypes.CDLL]:
    """The native loader (built if needed), or None when it cannot be built."""
    global _lib, build_error
    if _lib is not None:
        return _lib
    path = library_path() if os.path.exists(SOURCE) else None
    if path is None or (not os.path.exists(path) and not _build(path)):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:           # built elsewhere, or its libjpeg / libpng gone
        build_error = str(e)
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i32 = ctypes.c_int32
    lib.il_preprocess_batch.argtypes = [ctypes.c_char_p, i32, i32, f32p, f32p, f32p, i32p, i32]
    lib.il_preprocess_batch.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native image loader unavailable: {build_error}")
    return lib


def preprocess_files(paths: Sequence[str], image_size: int = 224,
                     num_threads: int = 0) -> np.ndarray:
    """Decode and preprocess a batch of files in the C++ thread pool:
    (N, S, S, 3) float32 NHWC, normalized. Raises on the first file that
    fails; ``num_threads=0`` takes the hardware's thread count."""
    lib = _lib_or_raise()
    n = len(paths)
    out = np.empty((n, image_size, image_size, 3), np.float32)
    status = np.zeros((n,), np.int32)
    blob = b"".join(p.encode() + b"\0" for p in paths)
    lib.il_preprocess_batch(blob, n, image_size, IMAGENET_MEAN, IMAGENET_STD, out, status,
                            num_threads)
    bad = np.nonzero(status)[0]
    if bad.size:
        raise IOError(f"decode failed ({status[bad[0]]}): {paths[bad[0]]}")
    return out


def imagenet_val_batches_native(images_dir: str, batch_size: int, image_size: int = 224,
                                max_batches: Optional[int] = None, num_threads: int = 0
                                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The native twin of ``data.imagenet_val_batches`` (a last partial
    batch included)."""
    samples = _list_val_samples(os.path.join(images_dir, "val"))
    produced = 0
    for i in range(0, len(samples), batch_size):
        chunk = samples[i:i + batch_size]
        labels = np.asarray([lab for _, lab in chunk], np.int32)
        yield preprocess_files([p for p, _ in chunk], image_size, num_threads), labels
        produced += 1
        if max_batches is not None and produced >= max_batches:
            return
