"""Time and profile the FIXED forward of the model ``validate-quantized`` builds.

    python -m fp8_quantization_tpu_torch.eval.profile_forward [--reps N] \\
        validate-quantized --architecture vit_quantized_approx --synthetic-data ...

Takes the CLI's own arguments, builds and calibrates the model as
``validate-quantized`` does (seeded weights, the init forward, the first
synthetic batch), then on the GPU:

* times ``--reps`` FIXED forwards of that batch after one warm-up, each ended
  by a synchronize (host clock);
* profiles one more FIXED forward with ``torch.profiler``: device time by
  kernel, summed, and its share of the forward's wall time (the device's
  busy share; one stream, so kernels do not overlap);
* counts K3 launches per forward.

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
from ..ops.cuda import approx_matmul as k3
from ..quant.sites import FIXED
from .driver import calibrate


def profile_forward(model, x, top: int):
    """(wall ms, device ms, [(kernel, ms, calls)] of the ``top`` heaviest)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(x, FIXED)
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

    model, device, _ = cli.setup(args)
    (x, _), = cli.make_batches(args, model, 1)
    calibrate(model, [x], num_est_batches=1)
    xt = torch.from_numpy(x).to(device)
    model(xt, FIXED)
    cli.sync(device)

    times, launches = [], []
    for _ in range(ns.reps):
        before = k3.approx_matmul.launches
        t0 = time.perf_counter()
        model(xt, FIXED)
        cli.sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
        launches.append(k3.approx_matmul.launches - before)
    wall_ms, device_ms, top = profile_forward(model, xt, ns.top)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": smi, "architecture": args.architecture, "batch": args.batch_size,
        "ms_per_forward": times, "ms_per_img_median": statistics.median(times) / args.batch_size,
        "k3_launches_per_forward": launches,
        "profiled": {"wall_ms": wall_ms, "device_ms": device_ms,
                     "busy_share": device_ms / wall_ms,
                     "top_kernels": [{"kernel": k, "ms": ms, "calls": n} for k, ms, n in top]},
    }))


if __name__ == "__main__":
    main()
