"""Profiling: ``torch.profiler`` traces and per-op roofline accounting (port
of ``utils/profiling.py``).

* ``trace`` -- capture a ``torch.profiler`` trace of a block (host and, on a
  GPU, device activity) and write it as a Chrome trace (``trace.json``,
  opened in ``chrome://tracing`` or Perfetto);
* ``benchmark`` -- best-of-N wall-clock seconds per call of a function,
  synchronizing the device where JAX blocks on the result;
* ``roofline`` -- achieved fraction of peak FLOPs / HBM bandwidth, so every
  hot kernel can be held to its speed of light.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch

# Peak numbers per card, by the name ``torch.cuda.get_device_name`` gives
# (NVIDIA's H100 SXM data sheet): dense bf16 tensor-core TFLOP/s and HBM3
# GB/s
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_gbps": 3350.0},
}

TRACE_FILE = "trace.json"


def _default_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def device_peaks(device=None) -> Dict[str, float]:
    """``PEAKS`` of ``device`` (the current CUDA device, else the CPU); NaN
    for a device it does not know, such as the CPU."""
    device = torch.device(device) if device is not None else _default_device()
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        for key, peaks in PEAKS.items():
            if key.lower() in name.lower():
                return dict(peaks)
    return {"bf16_tflops": float("nan"), "hbm_gbps": float("nan")}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace around a block and write it to
    ``log_dir/trace.json``; yields the ``torch.profiler.profile`` (its
    ``events()`` / ``key_averages()`` read the same trace)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, iters: int = 100, repeats: int = 3) -> float:
    """Best-of-N pipelined wall-clock seconds per call of ``fn``, after one
    warm-up call; the device is synchronized before each clock read."""
    fn(*args)
    _synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _synchronize()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def roofline(
    seconds_per_call: float,
    flops: float = 0.0,
    bytes_accessed: float = 0.0,
    device=None,
) -> Dict[str, float]:
    """Achieved TFLOP/s + GB/s and their fractions of the card's peaks."""
    peaks = device_peaks(device)
    tflops = flops / seconds_per_call / 1e12 if flops else 0.0
    gbps = bytes_accessed / seconds_per_call / 1e9 if bytes_accessed else 0.0
    return {
        "seconds_per_call": seconds_per_call,
        "tflops": tflops,
        "gbps": gbps,
        "flops_fraction_of_peak": tflops / peaks["bf16_tflops"],
        "bw_fraction_of_peak": gbps / peaks["hbm_gbps"],
    }
