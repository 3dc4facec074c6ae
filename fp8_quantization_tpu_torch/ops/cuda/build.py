"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, for ``sm_90a``, into a shared library with
a plain C interface under ``fp8_quantization_tpu_torch/build/``. The file
name carries a digest of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt and never mixed with an
old library. Builds happen at first use (or
all at once, in parallel, through :func:`build_all`); nothing is compiled
when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("approx_matmul", "fused_matmul", "dequant_matmul", "int4_matmul", "attention",
           "decode_attention")

# -fmad=false keeps every multiply and add separately rounded, as in the
# plain PyTorch versions; no --use_fast_math (it flushes subnormals)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all started together. Returns ``{name: {"seconds", "log",
    "path"}}`` (``log`` holds ``ptxas`` register/spill lines; empty when the
    library was already built). Raises with the compiler's output on failure.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    out = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            out[name] = {"seconds": 0.0, "log": "", "path": path}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, path)
    failed = []
    for name, (proc, t0, tmp, path) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"seconds": seconds, "log": log, "path": path}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all([name])[name]["path"]
        lib = _LOADED[name] = ctypes.CDLL(path)
    return lib
