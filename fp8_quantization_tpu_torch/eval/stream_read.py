"""How fast K5 route A's weight access pattern streams from HBM, read by
plain 16-byte loads into registers and through a cp.async ring.

    python -m fp8_quantization_tpu_torch.eval.stream_read

Builds ``eval/stream_read.cu`` (beside this script, not a kernel of the
port, with the port's nvcc flags) and times, by CUDA events, one read of Llama-3-8B's nibble-packed
lm_head (2048 x 128256 bytes, 263 MB) and of its gate projection (2048 x
14336 bytes, rotating over 8 copies so that the reads come from HBM rather
than the 50 MB L2) at several grid sizes, in three modes: registers
(``__ldg``), and cp.async rings of depth 2 and 3. Prints one JSON line per
case with its GB/s beside the card's name and power limit. Needs a GPU.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import torch

from ..ops.cuda import build

MODES = {0: "registers (__ldg)", 2: "cp.async ring, depth 2", 3: "cp.async ring, depth 3"}
# (rows, N, copies read in turn)
MATRICES = ((2048, 128256, 1), (2048, 14336, 8))
SPLITS = (1, 2, 4, 8)


def _library():
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, "libstream_read.so")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "stream_read.cu")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", path, src]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    fn = ctypes.CDLL(path).fp8q_stream_read
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available():
        raise SystemExit("stream_read: no CUDA device")
    dev = torch.device("cuda", 0)
    fn = _library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for rows, n, copies in MATRICES:
        gen = torch.Generator(device=dev).manual_seed(0)
        ws = [torch.randint(0, 256, (rows, n), generator=gen, device=dev, dtype=torch.uint8)
              for _ in range(copies)]
        for depth, mode in MODES.items():
            for splits in SPLITS:
                def read(i):
                    err = fn(depth, ws[i % copies].data_ptr(), rows, n, splits,
                             sink.data_ptr(), stream)
                    if err != 0:
                        raise RuntimeError(f"stream_read launch failed: CUDA error {err}")
                reps = 16
                read(0)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize()
                torch.cuda._sleep(10_000_000)
                start.record()
                for i in range(reps):
                    read(i + 1)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / reps
                print(json.dumps({"card": card, "rows": rows, "n": n, "copies": copies,
                                  "mode": mode, "ctas": n // 128 * splits, "us": 1e3 * ms,
                                  "GB_per_s": rows * n / ms / 1e6}), flush=True)


if __name__ == "__main__":
    main()
