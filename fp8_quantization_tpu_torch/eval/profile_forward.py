"""Time and profile one forward of the model ``validate-quantized`` builds.

    python -m fp8_quantization_tpu_torch.eval.profile_forward [--reps N] \\
        validate-quantized --architecture vit_quantized_approx --synthetic-data ...

Any architecture the CLI builds (ViT-B/16, MobileNetV2, ResNet-18/50).

Takes the CLI's own arguments, builds and calibrates the model as
``validate-quantized`` does (seeded weights, the init forward, the first
synthetic batch; with ``--packed-weights`` also the weight cache and the
1-byte codes), then on the GPU, in the phase the serving flags select
(``FIXED``, or ``--fast-mode`` / ``--packed-weights`` / ``--chained-acts``):

* times ``--reps`` forwards of that batch after one warm-up, each ended by a
  synchronize (host clock);
* profiles one more forward with ``torch.profiler``: device time by kernel,
  summed, and its share of the forward's wall time (the device's busy
  share; one stream, so kernels do not overlap);
* counts each kernel's launches per forward (K1 ``quantize_block``, K2
  ``fused_quant_matmul``, K3 ``approx_matmul``, K4 ``dequant_matmul``).

Prints one JSON object. Needs a GPU and raises without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from .. import cli
from ..ops.cuda import KERNELS
from ..ops.fastpath import pack_dense_caches
from ..quant.sites import QuantPhase
from .driver import cache_quantized_weights, calibrate


def _counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def profile_forward(model, x, qp, top: int):
    """(wall ms, device ms, [(kernel, ms, calls)] of the ``top`` heaviest)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(x, qp)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return wall_ms, device_ms, [(e.key[:90], e.self_device_time_total / 1e3, e.count)
                                for e in kernels[:top]]


@torch.no_grad()
def main(argv=None):
    p = argparse.ArgumentParser(prog="fp8_quantization_tpu_torch.eval.profile_forward")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("cli_args", nargs=argparse.REMAINDER,
                   help="the validate-quantized command line")
    ns = p.parse_args(argv)
    args = cli.build_parser().parse_args(ns.cli_args)
    if not args.cuda or not torch.cuda.is_available():
        raise RuntimeError("profile_forward measures the GPU: it needs --cuda and a GPU")

    model, device, qc, example = cli.setup(args)
    (x, _), = cli.make_batches(args, model, 1)
    calibrate(model, [x], num_est_batches=1)
    if args.packed_weights:
        cache_quantized_weights(model, example, fast=args.fast_mode)
        pack_dense_caches(model, qc)
    qp = QuantPhase(fast=args.fast_mode, packed=args.packed_weights,
                    chained=args.chained_acts)
    xt = torch.from_numpy(x).to(device)
    model(xt, qp)
    cli.sync(device)

    times, launches = [], []
    for _ in range(ns.reps):
        before = _counts()
        t0 = time.perf_counter()
        model(xt, qp)
        cli.sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
        launches.append({k: v - before[k] for k, v in _counts().items()})
    wall_ms, device_ms, top = profile_forward(model, xt, qp, ns.top)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": smi, "architecture": args.architecture, "batch": args.batch_size,
        "phase": {"fast": qp.fast, "packed": qp.packed, "chained": qp.chained},
        "ms_per_forward": times, "ms_per_img_median": statistics.median(times) / args.batch_size,
        "launches_per_forward": launches,
        "profiled": {"wall_ms": wall_ms, "device_ms": device_ms,
                     "busy_share": device_ms / wall_ms,
                     "top_kernels": [{"kernel": k, "ms": ms, "calls": n} for k, ms, n in top]},
    }))


if __name__ == "__main__":
    main()
