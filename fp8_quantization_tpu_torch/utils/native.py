"""ctypes bindings for the native (C++) ExMy codec, ``runtime/exmy_codec.cc``
(port of ``utils/native.py``).

The C++ file is an independent implementation of the quantization numerics:
a cross-language bit-exactness oracle for ``numerics/codec.py`` and
``numerics/fp8_ste.py``, and a host-side quantizer for tools that need
neither framework. It is built at first use with the local ``g++`` into
``fp8_quantization_tpu_torch/build/`` (a name carrying a digest of the
source and the flags); where no compiler is found, :func:`available` is
False and the entry points raise, and nothing fails at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "runtime", "exmy_codec.cc")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib = None


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libexmy_codec_{h.hexdigest()[:12]}.so")


def _build(path: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None or not os.path.exists(SOURCE):
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)          # atomic: a concurrent loader sees all or nothing
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return True


def load() -> Optional[ctypes.CDLL]:
    """The native codec (built if needed), or None when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path() if os.path.exists(SOURCE) else None
    if path is None or (not os.path.exists(path) and not _build(path)):
        return None
    lib = ctypes.CDLL(path)
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.exmy_decompose.argtypes = [f32p, i32p, i32p, i64, i32, i32, i32, i32]
    lib.exmy_compose.argtypes = [i32p, i32p, f32p, f32p, i64, i32, i32]
    lib.exmy_quantize.argtypes = [f32p, f32p, i64, i32, i32, i32, i32]
    lib.fp8_ste_quantize.argtypes = [f32p, f32p, i64, i32, ctypes.c_float, i32, i32,
                                     ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native codec unavailable (no g++, or the build failed)")
    return lib


def exmy_quantize(x: np.ndarray, expo_width: int, mant_width: int, bias: int,
                  clip_of: bool = True) -> np.ndarray:
    lib = _lib_or_raise()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(x)
    lib.exmy_quantize(x.ravel(), out.ravel(), x.size, expo_width, mant_width, bias,
                      int(clip_of))
    return out


def exmy_decompose(x: np.ndarray, expo_width: int, mant_width: int, bias: int,
                   clip_of: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    lib = _lib_or_raise()
    x = np.ascontiguousarray(x, np.float32)
    expo = np.empty(x.shape, np.int32)
    mant = np.empty(x.shape, np.int32)
    lib.exmy_decompose(x.ravel(), expo.ravel(), mant.ravel(), x.size, expo_width,
                       mant_width, bias, int(clip_of))
    return expo, mant


def exmy_compose(expo: np.ndarray, mant: np.ndarray, sign: np.ndarray, mant_width: int,
                 bias: int) -> np.ndarray:
    lib = _lib_or_raise()
    expo = np.ascontiguousarray(expo, np.int32)
    mant = np.ascontiguousarray(mant, np.int32)
    sign = np.ascontiguousarray(sign, np.float32)
    out = np.empty(expo.shape, np.float32)
    lib.exmy_compose(expo.ravel(), mant.ravel(), sign.ravel(), out.ravel(), expo.size,
                     mant_width, bias)
    return out


def fp8_ste_quantize(x: np.ndarray, n_bits: int, maxval: float, mant_bits: int,
                     sign_bits: int) -> Tuple[np.ndarray, int]:
    lib = _lib_or_raise()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(x)
    bias = ctypes.c_int32(0)
    lib.fp8_ste_quantize(x.ravel(), out.ravel(), x.size, n_bits, ctypes.c_float(maxval),
                         mant_bits, sign_bits, ctypes.byref(bias))
    return out, int(bias.value)
