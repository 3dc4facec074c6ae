"""Where the time of one kernel launch goes, by phase.

    python -m fp8_quantization_tpu_torch.eval.stamps [--kernel K5|K6|K7] [--reps N]

Builds the kernel's source once more with ``-DFP8Q_STAMPS``
(``csrc/stamps.cuh``: thread 0 of every CTA adds the ``clock64()`` cycles
between the kernel's ``STAMP(i)`` points to slot ``i`` and notes its start
and end on the card's global nanosecond timer), runs it through the port's
wrapper and prints one JSON line per shape: the launch's time by CUDA
events, the SM clock, how long the CTAs took from the first start to the last
end and when the last one started, and the cycles of every phase: the mean
over the CTAs and the CTA that took longest. Shapes: K6 (decode attention)
at Llama-3-8B's decode (4 slots of a 2048-key slab, 32 query and 8 kv heads
of 128) in bf16 and in uint8 codes at three steps' lengths; K7 (fused SDPA)
at Llama-3-8B's cold prefill chunks and ViT-B/16's batch-8 attention; K5
(int4 nibble GEMM) at Llama-3-8B's four decode projection shapes (M = 4
slots) and a 512-row prefill chunk of the gate projection. Each output is
also held to its plain version (K5 and K6 equal, K7 within its contract).
Needs a GPU; the port's own libraries are never built with the stamps.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from ..ops.cuda import attention as k7
from ..ops.cuda import build
from ..ops.cuda import decode_attention as k6
from ..ops.cuda import dequant_matmul as k5

# the STAMP(i) slots of each kernel's source, in order
PHASES = {
    "K6": ("setup", "K landed (and decoded)", "scores", "sub-chunk max and cluster barrier",
           "block max, p, sum(p), V landed (and decoded)", "p @ v", "cluster barrier",
           "combine (CTA 0)", "epilogue"),
    "K7": ("setup", "tile landed", "q k^T and mask", "pass 1 max and sum",
           "pass 2 p and p @ v", "epilogue"),
    "K5": ("setup (route B: ring primed)",
           "route A: every step, loads and mma; route B: stage landed, its barrier",
           "route B: nibble expansion, its barrier", "route B: tensor-core mma",
           "partial sums in shared memory", "store (split K: cluster combine)"),
}
# per kernel: its source, wrapper module, the module's library loader and
# the C entry
SOURCES = {"K5": ("int4_matmul", k5, "_int4_lib", "fp8q_int4_matmul"),
           "K6": ("decode_attention", k6, "_lib", "fp8q_decode_attention"),
           "K7": ("attention", k7, "_lib", "fp8q_fused_sdpa")}
# decode-step lengths of Llama-3-8B serving in chip_smoke.py (prompts of 17,
# 100, 256 and 511 tokens): the first step, a middle one and the last
LENGTHS = ((18, 101, 257, 512), (34, 117, 273, 528), (49, 132, 288, 543))
B, S, H, HK, D = 4, 2048, 32, 8, 128
# Llama-3-8B's cold prefill chunks in chip_smoke.py's serving run
CHUNKS = (32, 64, 112, 256, 512)
# K5's (M, K, N): Llama-3-8B's k/v, gate/up, down and lm_head projections
# at M = 4 decode slots, and the gate projection at a 512-row prefill chunk
K5_SHAPES = ((4, 4096, 1024), (4, 4096, 14336), (4, 14336, 4096), (4, 4096, 128256),
             (512, 4096, 14336))
# stamp rows read back: more than any kernel launches at these shapes
MAX_CTAS = 8192


def _stamped_library(kernel):
    name, module, loader, entry = SOURCES[kernel]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, f"lib{name}_stamps.so")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-DFP8Q_STAMPS", "-o", path,
           build.source_path(name)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(path)
    fn = getattr(lib, entry)
    ref = getattr(module, loader)()   # the port's own build: its argument types
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    lib.fp8q_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fp8q_read_stamps.restype = ctypes.c_int
    lib.fp8q_stamp_slots.restype = ctypes.c_int
    setattr(module, loader, lambda: fn)   # the wrapper launches the stamped build
    return lib


def _read(lib, n_ctas):
    """(n_ctas, slots + 3): each CTA's phase cycles, total cycles, and start
    and end on the global nanosecond timer."""
    slots = lib.fp8q_stamp_slots()
    buf = np.zeros((n_ctas, slots + 3), dtype=np.int64)
    err = lib.fp8q_read_stamps(buf.ctypes.data, n_ctas)
    if err != 0:
        raise RuntimeError(f"reading the stamps failed: CUDA error {err}")
    return buf


def _sm_clock_mhz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def _cases(kernel, dev):
    """(description, launch, check) per shape: ``check(out)`` is the plain
    version's verdict on one launch's output."""
    gen = torch.Generator(device=dev).manual_seed(5)
    if kernel == "K5":
        from ..ops.fastpath import pack_int4

        for m, k, n in K5_SHAPES:
            x = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
            w4 = pack_int4(torch.randint(-8, 8, (k, n), generator=gen, device=dev,
                                         dtype=torch.int8))
            yield ({"m": m, "k": k, "n": n},
                   lambda x=x, w4=w4, k=k: k5.int4_matmul(x, w4, k=k),
                   lambda out, x=x, w4=w4, k=k: torch.equal(
                       out, k5.int4_matmul_plain(x, w4, k=k)))
        return
    if kernel == "K6":
        from ..numerics.codec import pack_exmy

        q = torch.randn((B, H, D), generator=gen, device=dev)
        kf, vf = (torch.randn((B, S, HK, D), generator=gen, device=dev) for _ in range(2))
        kb, vb = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (4, 5))
        forms = {"bf16": (kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}),
                 "codes": (pack_exmy(kf, 3, 4, kb, clip_of=True),
                           pack_exmy(vf, 3, 4, vb, clip_of=True),
                           dict(k_bias=kb, v_bias=vb, kv_expo=3, kv_mant=4))}
        for form, (ks, vs, kw) in forms.items():
            for lengths in LENGTHS:
                lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
                yield ({"form": form, "lengths": list(lengths)},
                       lambda ks=ks, vs=vs, kw=kw, lens=lens: k6.decode_attention(
                           q, ks, vs, lens, **kw),
                       lambda out, ks=ks, vs=vs, kw=kw, lens=lens: torch.equal(
                           out, k6.decode_attention_plain(q, ks, vs, lens, **kw)))
        return
    shapes = [((1, t, t, H, HK, D), dict(causal=True)) for t in CHUNKS]
    shapes.append(((8, 197, 197, 12, 12, 64), dict(s_valid=197)))
    for (b, t, s, h, hk, d), kw in shapes:
        q = torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, s, hk, d), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        yield ({"q": [b, t, h, d], "kv": [b, s, hk, d], **kw},
               lambda q=q, k=k, v=v, kw=kw: k7.fused_sdpa(q, k, v, **kw),
               lambda out, q=q, k=k, v=v, kw=kw: k7.within_sdpa_contract(out, q, k, v, **kw)[0])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(SOURCES), default="K6")
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stamps: no CUDA device")
    dev = torch.device("cuda", 0)
    lib = _stamped_library(args.kernel)
    phases = PHASES[args.kernel]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for what, run, check in _cases(args.kernel, dev):
        ok = bool(check(run()))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(args.reps):
            run()
        end.record()
        torch.cuda.synchronize()
        us = 1e3 * start.elapsed_time(end) / args.reps
        clock = _sm_clock_mhz()
        torch.cuda.synchronize()
        if lib.fp8q_clear_stamps() != 0:
            raise RuntimeError("clearing the stamps failed")
        run()
        torch.cuda.synchronize()
        st = _read(lib, MAX_CTAS)
        st = st[st[:, -3] > 0]
        first, last = st[:, -2], st[:, -1]
        st = st[:, :-2]
        worst = st[int(np.argmax(st[:, -1]))]
        mean = st.mean(axis=0)
        print(json.dumps({
            "kernel": args.kernel, **what, "us_per_launch": us, "plain_agrees": ok,
            "sm_clock_mhz": clock, "ctas": len(st),
            "ctas_span_us": float(last.max() - first.min()) / 1e3,
            "last_cta_start_us": float(first.max() - first.min()) / 1e3,
            "mean_cycles": {p: float(mean[i]) for i, p in enumerate(phases)}
            | {"total": float(mean[-1])},
            "longest_cta_cycles": {p: int(worst[i]) for i, p in enumerate(phases)}
            | {"total": int(worst[-1])},
        }), flush=True)


if __name__ == "__main__":
    main()
