"""Where the time of one attention-kernel launch goes, by phase.

    python -m fp8_quantization_tpu_torch.eval.stamps [--kernel K6|K7] [--reps N]

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
at Llama-3-8B's cold prefill chunks and ViT-B/16's batch-8 attention. Each
output is also held to its plain version (K6 equal, K7 within its contract).
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

# the STAMP(i) slots of each kernel's source, in order
PHASES = {
    "K6": ("setup", "K landed (and decoded)", "scores", "sub-chunk max and cluster barrier",
           "block max, p, sum(p), V landed (and decoded)", "p @ v", "cluster barrier",
           "combine (CTA 0)", "epilogue"),
    "K7": ("setup", "tile landed", "q k^T and mask", "pass 1 max and sum",
           "pass 2 p and p @ v", "epilogue"),
}
SOURCES = {"K6": ("decode_attention", k6), "K7": ("attention", k7)}
# decode-step lengths of Llama-3-8B serving in chip_smoke.py (prompts of 17,
# 100, 256 and 511 tokens): the first step, a middle one and the last
LENGTHS = ((18, 101, 257, 512), (34, 117, 273, 528), (49, 132, 288, 543))
B, S, H, HK, D = 4, 2048, 32, 8, 128
# Llama-3-8B's cold prefill chunks in chip_smoke.py's serving run
CHUNKS = (32, 64, 112, 256, 512)
# stamp rows read back: more than either kernel launches at these shapes
MAX_CTAS = 1024


def _stamped_library(kernel):
    name, module = SOURCES[kernel]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, f"lib{name}_stamps.so")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-DFP8Q_STAMPS", "-o", path,
           build.source_path(name)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(path)
    fn = getattr(lib, "fp8q_decode_attention" if kernel == "K6" else "fp8q_fused_sdpa")
    ref = module._lib()            # the port's own build: its argument types
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    lib.fp8q_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fp8q_read_stamps.restype = ctypes.c_int
    lib.fp8q_stamp_slots.restype = ctypes.c_int
    module._lib = lambda: fn       # the wrapper launches the stamped build
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
