#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero; no phase is skipped):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every CUDA source of the port with ``nvcc`` for sm_90a.
3. kernels: the approximate-multiplier GEMM (K3) against its plain PyTorch
   version on the card, at the four ViT-B/16 layer shapes on a 64-row slice
   and in the eight flag cases of the JAX package's Pallas tests; times
   both at the shapes of a batch-8 forward.
4. main path: ``validate-quantized`` through the port's CLI on full-width
   ViT-B/16 (seeded random weights, synthetic data, batch 8, one calibration
   and two eval batches) with the approximate multiplier, counting kernel
   launches; then the reference's published flag set, which launches none.
5. model: full-width logits of the approximate ViT at depth 2, batch 1,
   through the kernel and through the plain version on the card.

Before the last line it prints one JSON object with each kernel's launches,
error, times and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import types

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores. The float32 rate counts an FMA as two
# operations, so the CUDA cores issue half as many instructions a second;
# K3's per-product work is such instructions (integer, float, shared loads),
# none of them a tensor-core instruction
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
CUDA_CORE_INSTR_PER_S = F32_OPS_PER_S / 2

# the flagship approx setting: E3M4 with the D3 compensation table
FLAGSHIP = dict(expo_width=3, mant_width=4, with_comp=True, dnsmp_factor=3,
                with_approx=True, with_s2nn2s_opt=False, quant_btw_mult_accu=True,
                golden_clip_of=False)
# the eight flag cases of tests/test_approx_pallas.py
CASES = [
    dict(expo_width=3, mant_width=4, with_comp=True),
    dict(expo_width=3, mant_width=4, with_comp=False),
    dict(expo_width=3, mant_width=4, with_comp=True, quant_btw_mult_accu=False),
    dict(expo_width=3, mant_width=4, with_comp=True, with_s2nn2s_opt=True),
    dict(expo_width=4, mant_width=3, with_comp=False),
    dict(expo_width=2, mant_width=5, with_comp=True),
    dict(expo_width=3, mant_width=4, with_comp=True, with_approx=False),
    dict(expo_width=3, mant_width=4, with_comp=True, golden_clip_of=True),
]
# ViT-B/16's approximate products at batch B: (name, M, K, N, launches per forward)
def layer_shapes(batch):
    return [
        ("qkv_attn_out", 197 * batch, 768, 768, 48),
        ("patch_conv", 196 * batch, 768, 768, 1),
        ("intermediate", 197 * batch, 768, 3072, 12),
        ("output", 197 * batch, 3072, 768, 12),
        ("classifier", batch, 768, 1000, 1),
    ]


LAUNCHES_PER_FORWARD = 74
BATCH = 8
# the kernel-against-plain check: the four distinct (K, N) of ViT-B/16's
# approximate products, on a row slice (the plain version holds (rows, K, N))
SLICE_ROWS = 64
SLICE_SHAPES = ((768, 768), (768, 3072), (3072, 768), (768, 1000))
PUBLISHED_FLAGS = [
    "validate-quantized", "--synthetic-data", "--architecture", "vit_quantized",
    "--batch-size", str(BATCH), "--seed", "10", "--n-bits", "8", "--load-type", "fp32",
    "--quant-setup", "all", "--qmethod", "fp_quantizer", "--per-channel",
    "--fp8-mantissa-bits", "4", "--fp8-set-maxval", "--no-fp8-mse-include-mantissa-bits",
    "--weight-quant-method", "current_minmax", "--act-quant-method", "allminmax",
    "--num-est-batches", "1", "--quantize-input", "--no-approx_flag",
    "--no-quantize-after-mult-and-add", "--res-quantizer-flag", "--original-quantize-res",
    "--expo-width", "3", "--mant-width", "4", "--dnsmp-factor", "3",
    "--approx-output-dir", "approx_output", "--max-eval-batches", "2",
]
# the approx run method on the same flags
APPROX_FLAGS = [{"vit_quantized": "vit_quantized_approx",
                 "--no-approx_flag": "--approx_flag"}.get(f, f)
                for f in PUBLISHED_FLAGS] + ["--withComp", "--with_approx"]


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def grid_operands(m, k, n, device, seed, *, ew=3, mw=4, bias_a=5, bias_b=None):
    """Operands on their ExMy grids: activations of unit scale (bias 5) and
    lecun-scaled weights with per-column biases around 12, as calibration
    gives them at these widths."""
    from fp8_quantization_tpu_torch.numerics.codec import quantize_exmy

    rng = np.random.default_rng(seed)
    if bias_b is None:
        bias_b = rng.integers(11, 14, size=n).astype(np.int32)
    a = quantize_exmy(torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32) * 2),
                      ew, mw, bias_a)
    w = rng.normal(size=(k, n)).astype(np.float32) * np.float32(k ** -0.5)
    b = quantize_exmy(torch.from_numpy(w), ew, mw, torch.from_numpy(bias_b).reshape(1, -1))
    return a.to(device), b.to(device), torch.from_numpy(bias_b).to(device)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events, after
    one warm-up run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel_against_plain(k3, dev, instr_per_product):
    """Phase 3: returns (max_abs_err, per-forward ms / plain ms / bound ms).
    The bound is the larger of the bytes over HBM bandwidth and the
    products times ``instr_per_product`` (counted in the built kernel's SASS)
    over the CUDA cores' instruction rate."""
    from fp8_quantization_tpu_torch.numerics.approx_matmul import approx_products
    from fp8_quantization_tpu_torch.numerics.luts import get_error_table

    worst = 0.0
    bias_a, bias_r = 5, 5
    # the four layer shapes on a row slice; tolerance from f32
    # accumulation: |kernel - plain| <= K * 2^-24 * sum_k |term_k|
    for k, n in SLICE_SHAPES:
        a, b, bb = grid_operands(SLICE_ROWS, k, n, dev, seed=k + n)
        ours = k3.approx_matmul(a, b, bias_a, bb, bias_r, **FLAGSHIP)
        plain = k3.approx_matmul_plain(a, b, bias_a, bb, bias_r, **FLAGSHIP)
        table = get_error_table(3, 4, True, 3)
        flags = {key: FLAGSHIP[key] for key in ("with_approx", "with_s2nn2s_opt",
                                                  "golden_clip_of", "quant_btw_mult_accu")}
        abs_terms = approx_products(a, b, 3, 4, bias_a, bb, bias_r, table,
                                    **flags).abs().sum(dim=1)
        err = (ours - plain).abs()
        tol = k * 2.0 ** -24 * abs_terms
        ok = bool((err <= tol).all()) and bool(torch.isfinite(ours).all())
        worst = max(worst, float(err.max()))
        phase("kernels", f"K3 {SLICE_ROWS}x{k}x{n} flagship: max|d|={float(err.max()):.3g} "
                         f"max tol={float(tol.max()):.3g} ok={ok}")
        if not ok:
            raise SystemExit(f"K3 disagrees with its plain version at {k}x{n}")
        del abs_terms
    # the eight flag cases and a per-column bias at K <= 64: rtol=atol=1e-6
    for i, case in enumerate(CASES):
        flags = {**FLAGSHIP, **case}
        a, b, bb = grid_operands(70, 40, 70, dev, seed=100 + i, ew=flags["expo_width"],
                                 mw=flags["mant_width"],
                                 bias_b=np.resize(np.arange(3, 9, dtype=np.int32), 70))
        ours = k3.approx_matmul(a, b, 5, bb, 4, **flags)
        plain = k3.approx_matmul_plain(a, b, 5, bb, 4, **flags)
        err = float((ours - plain).abs().max())
        worst = max(worst, err)
        ok = torch.allclose(ours, plain, rtol=1e-6, atol=1e-6)
        phase("kernels", f"K3 case {i} {case}: max|d|={err:.3g} ok={ok}")
        if not ok:
            raise SystemExit(f"K3 disagrees with its plain version in case {case}")
    # a site that saw only zeros (the CLI's init forward) has bias +inf: the
    # zero operand's products stay zero and the LUT reads in bounds
    _, b, bb = grid_operands(70, 40, 70, dev, seed=99)
    inf = torch.tensor(float("inf"), device=dev)
    zeros = torch.zeros((70, 40), device=dev)
    ours = k3.approx_matmul(zeros, b, inf, bb, inf, **FLAGSHIP)
    plain = k3.approx_matmul_plain(zeros, b, inf, bb, inf, **FLAGSHIP)
    ok = bool((ours == 0).all()) and bool((plain == 0).all())
    phase("kernels", f"K3 zero operand, bias +inf: all zero {ok}")
    if not ok:
        raise SystemExit("K3 gives nonzero products for a zero operand")

    # times at the shapes of one batch-8 forward
    totals = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for name, m, k, n, count in layer_shapes(BATCH):
        a, b, bb = grid_operands(m, k, n, dev, seed=m + k + n)
        ms = cuda_ms(lambda: k3.approx_matmul(a, b, bias_a, bb, bias_r, **FLAGSHIP), 5)
        plain_ms = cuda_ms(
            lambda: k3.approx_matmul_plain(a, b, bias_a, bb, bias_r, **FLAGSHIP), 1)
        nbytes = 4 * (m * k + k * n + m * n + n + 2 + 16 * 16)
        ops = m * k * n * instr_per_product
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / CUDA_CORE_INSTR_PER_S
        bound_ms = max(bytes_ms, ops_ms)
        phase("kernels", f"K3 {name} {m}x{k}x{n} x{count}/forward: kernel {ms:.4f} ms, "
                         f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({m * k * n / ms / 1e6:.4g} G products/s)")
        totals["ms"] += count * ms
        totals["plain_ms"] += count * plain_ms
        totals["bytes_ms"] += count * bytes_ms
        totals["ops_ms"] += count * ops_ms
    totals["bound_ms"] = max(totals["bytes_ms"], totals["ops_ms"])
    totals["bound_by"] = "operations" if totals["ops_ms"] >= totals["bytes_ms"] else "bytes"
    return worst, totals


def run_cli(cli, argv):
    args = cli.build_parser().parse_args(argv)
    out = cli.run_validate(args)
    ms_per_img = 1e3 * out["validate_s"] / out["images"]
    return out, ms_per_img


@contextlib.contextmanager
def plain_approx_products(layers_mod, k3):
    """Route the layers' approximate products to the plain version."""
    saved = layers_mod.k3
    layers_mod.k3 = types.SimpleNamespace(approx_matmul=k3.approx_matmul_plain)
    try:
        yield
    finally:
        layers_mod.k3 = saved


def check_model(cli, argv, dev, spec):
    """Phase 5: logits of the approximate ViT through the kernel and through
    its plain version, from one calibrated state."""
    from fp8_quantization_tpu_torch.eval.data import synthetic_batches
    from fp8_quantization_tpu_torch.eval.driver import calibrate
    from fp8_quantization_tpu_torch.models.vit import QuantizedViT
    from fp8_quantization_tpu_torch.ops import layers as layers_mod
    from fp8_quantization_tpu_torch.ops.cuda import approx_matmul as k3
    from fp8_quantization_tpu_torch.quant.sites import FIXED

    qc = cli.config_from_args(cli.build_parser().parse_args(argv))
    model = QuantizedViT(qc=qc, spec=spec,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    (x, _), = synthetic_batches(1, 1, image_size=spec.image_size,
                                num_classes=spec.num_classes, seed=3)
    calibrate(model, [x], num_est_batches=1)
    xt = torch.from_numpy(x).to(dev)
    with torch.no_grad():
        logits = model(xt, FIXED)
        with plain_approx_products(layers_mod, k3):
            plain_logits = model(xt, FIXED)
    diff = float((logits - plain_logits).abs().max())
    scale = float(plain_logits.abs().max())
    # every approximate partial product is requantized onto the result grid,
    # so each is a multiple of 2^(1 - bias_r - M) and the f32 sums over K are
    # exact in any order at these magnitudes: the two agree to rounding
    same_top1 = bool((logits.argmax(-1) == plain_logits.argmax(-1)).all())
    ok = (tuple(logits.shape) == (1, spec.num_classes)
          and bool(torch.isfinite(logits).all())
          and diff <= 1e-5 * max(1.0, scale) and same_top1)
    phase("model", f"width {spec.hidden_size}, depth {spec.num_layers}, batch 1: "
                   f"max|kernel - plain| = {diff:.3g} (max|logit| {scale:.3g}), "
                   f"same top-1 {same_top1}, ok={ok}")
    if not ok:
        raise SystemExit("whole-model logits through K3 and its plain version disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from fp8_quantization_tpu_torch import cli
    from fp8_quantization_tpu_torch.models.vit import VIT_B_16
    from fp8_quantization_tpu_torch.ops.cuda import approx_matmul as k3
    from fp8_quantization_tpu_torch.ops.cuda import build, sass_mix

    # full-f32 products and convolutions (TF32 would leave the grid)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    phase("device", f"{kind} x{count}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        phase("build", f"{name}: {info['seconds']:.1f} s, {len(regs)} kernels; "
                       f"{regs[0] if regs else ''}")
    phase("build", f"all sources in {time.perf_counter() - t0:.1f} s")
    mix = sass_mix.instruction_mix(built["approx_matmul"]["path"])
    phase("build", f"K3 flagship loop: {mix['instructions_per_product']:.4g} instructions "
                   f"per product, by class {mix['per_product_by_class']}")

    # 3. kernels against their plain versions
    max_err, k3_times = check_kernel_against_plain(k3, dev, mix["instructions_per_product"])

    # 4. the main path
    k3.approx_matmul.launches = 0
    out, approx_ms = run_cli(cli, APPROX_FLAGS)
    launches = k3.approx_matmul.launches
    # the CLI's init forward (a zeros batch of one), one calibration batch
    # and two eval batches
    expected = LAUNCHES_PER_FORWARD * (1 + 1 + 2)
    phase("main", f"vit_quantized_approx: {out['metrics']}, {approx_ms:.2f} ms/img over "
                  f"{out['images']} images, K3 launches {launches} (expected {expected}), "
                  f"result {out['result_file']}")
    if launches != expected or not np.isfinite(out["metrics"]["loss"]):
        raise SystemExit("approx validate-quantized: wrong launch count or bad metrics")
    k3.approx_matmul.launches = 0
    out_pub, pub_ms = run_cli(cli, PUBLISHED_FLAGS)
    phase("main", f"vit_quantized (published flags): {out_pub['metrics']}, "
                  f"{pub_ms:.2f} ms/img over {out_pub['images']} images, "
                  f"K3 launches {k3.approx_matmul.launches}, result {out_pub['result_file']}")
    if k3.approx_matmul.launches != 0 or not np.isfinite(out_pub["metrics"]["loss"]):
        raise SystemExit("published validate-quantized launched K3 or gave bad metrics")

    # 5. whole-model check at full width, depth 2, batch 1
    check_model(cli, APPROX_FLAGS, dev, dataclasses.replace(VIT_B_16, num_layers=2))

    record = {"kernels": [{
        "name": "approx_matmul",
        "route": "cuda",
        "source": "fp8_quantization_tpu_torch/csrc/approx_matmul.cu",
        "replaces": "fp8_quantization_tpu/ops/pallas/approx_matmul.py:248",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k3_times["ms"],
        "plain_ms": k3_times["plain_ms"],
        "bound_ms": k3_times["bound_ms"],
        "bound_by": k3_times["bound_by"],
        "library_ms": None,
    }]}
    phase("done", f"approx ms/img {approx_ms:.2f}, published ms/img {pub_ms:.2f}; "
                  f"K3 per batch-{BATCH} forward: kernel {k3_times['ms']:.2f} ms, "
                  f"plain {k3_times['plain_ms']:.2f} ms, bound {k3_times['bound_ms']:.2f} ms; "
                  f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
