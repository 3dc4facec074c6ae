#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero; no phase is skipped):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every CUDA source of the port with ``nvcc`` for sm_90a,
   one ``nvcc`` per source, all at once; counts the tensor-core instructions
   in the SASS of each route of K2, K4 and K5 and of K7 (route B of K2/K4,
   both routes of K5 and K7 must have them) and K3's instructions a product.
3. kernels: the approximate-multiplier GEMM (K3) against its plain PyTorch
   version on the card, at the four ViT-B/16 layer shapes on a 64-row slice,
   in the eight flag cases of the JAX package's Pallas tests, on every
   single product of the E2M5 value space under s2nn2s, and on every single
   product (K = 1) of value space x value space in all eight cases across a
   sweep of result biases (bit for bit); the bit-ops
   quantizer (K1) on random, zero, subnormal, +-maxval and clip-edge inputs;
   the fused quant GEMM (K2) and the packed-FP8 dequant GEMM (K4) in every
   switch combination at the four dense shapes on a 64-row slice, unaligned
   ones, Llama-3-8B's decode shapes (k/v and down at 1, 2, 4, 16 rows,
   lm_head at 4) and 16 and 17 rows of 4096 x 4096: route A (M <= 16) equal
   to the plain version, route B (tensor cores) within
   ``fused_matmul.within_requant_step``'s contract; the fused SDPA (K7)
   within ``attention.within_sdpa_contract`` on a warm 2048-key slab with
   offsets, ViT-B/16's attention (timed per batch-8 forward) and an
   unaligned shape, each also with its requant epilogue (equal to K1 of the
   kernel's own context); the decode attention (K6) equal to its plain
   version bit for bit over Llama-3-8B's 2048-slot slabs in bf16 and in
   uint8 codes, at lengths on its 64-key sub-chunk and 512-key block edges,
   and at an S off its key block; the int4 nibble GEMM (K5) equal to its plain version at
   Llama-3-8B's decode and prefill shapes, at 16 and 17 rows (its route
   edge) and at unaligned shapes with odd K on both routes, timed beside
   ``torch._int_mm``; K3 at every distinct (K, N) of MobileNetV2's and
   ResNet-18's ungrouped products (the stems' K = 27 and 147, N = 16..1280,
   K up to 4608) on a 64-row slice, equal to its plain version (its sums
   are exact there), then timed at
   every product of a batch-16 forward beside its bound; the int8 conv's
   int32 sums (``fastpath.int8_conv_sums``) at every distinct conv of
   MobileNetV2 and ResNet-18 on a row slice, with the zero point's code 0
   and -128, equal to the CPU's, and timed per batch-16 forward beside
   cuDNN's f32 convolution of the same codes. At the shapes of a batch-8 forward, in the configurations the main
   path launches (K1 at every size it sees, K2 on bf16 x, K4 on bf16 and on
   coded x), checks each GEMM kernel against its plain version again and
   times it, its plain version and (for the GEMMs) cuBLAS, beside the card's
   bound.
4. main path: ``validate-quantized`` through the port's CLI on full-width
   ViT-B/16 (seeded random weights, synthetic data, batch 8, one calibration
   and two eval batches): with the approximate multiplier (K3); with the
   reference's published flag set, which launches none; and with the
   published flags in the serving modes ``--fast-mode`` (K1, K2),
   ``--fast-mode --packed-weights`` and ``... --chained-acts`` (K1, K4).
   Then ``validate-quantized`` on the CNNs at full width, batch 16:
   ``mobilenet_v2_quantized`` published, approx (K3 on the ungrouped convs
   and the classifier, the oracle on the depthwise ones), ``--fast-mode``
   (K1, K2) and ``--fast-mode --packed-weights`` (K1, K4);
   ``resnet18_quantized`` published and approx; ``resnet50_quantized``
   published and ``--fast-mode``; then the serving boundary: the published
   flags with ``--fast-mode --packed-weights --chained-acts`` (the FP8 fused
   ``Affine`` boundary) on all three, ``scripts/bench_cnn.py``'s int8 flags
   with ``--packed-weights`` (the int8 conv) on MobileNetV2 and ResNet-18
   and with ``--chained-acts`` (the int8 fused boundary) on all three, w4a8
   ``--chained-acts`` on MobileNetV2 (K5 for the classifier) and the int8
   flags with ``--packed-weights`` and ``--chained-acts`` on ViT-B/16 (its
   patch embedding an int8 conv); each run's launches, oracle calls and
   int8 conv calls equal to the counts its shapes imply
   (``cnn_expected``), and its ms/img printed beside the card's name and
   power limit.
   Then ``ContinuousBatcher`` serving Llama-3-8B at full width (32 layers,
   seeded random weights, calibrated as ``scripts/bench_llama.py`` does) with
   ``fused_sdpa=True``: 4 slots of 2048, greedy, prompts of 17, 100, 256 and
   511 tokens and a fifth of 64 admitted when a slot retires, 32 new tokens
   each; under FAST with a bf16 cache (K1, K2, K7, K6) and under PACKED with
   a uint8 cache (K1, K4, K7, K6 on codes); then, that model freed, built
   anew in the w4a8 configuration of ``scripts/bench_llama_big.py``
   (4-bit per-channel weights, 8-bit acts, symmetric uniform), packed to
   nibbles and served under PACKED with a bf16 cache (K5, K7, K6). Every
   run counts each kernel's launches with the counts zeroed just before it
   and holds them to the counts its shapes imply, and ``torch.profiler``
   then splits a decode step of each phase into device and host time. K7
   (to its contract), K6 (bit for bit) and K5 are checked and timed at every
   shape the runs gave them,
   beside their plain versions, ``scaled_dot_product_attention`` or
   ``torch._int_mm`` and the card's bound; K2 (f32 x quantized on the load)
   and K4 (bf16 x) at every Llama projection shape, at 4 decode rows and at
   the FAST run's admission chunks, beside ``torch.matmul`` and the bound,
   per decode step and per run's admissions.
5. model: full-width logits at depth 2 through the kernels and through their
   plain versions on the card, from one calibrated state: the approximate
   ViT; the published-flag ViT under PACKED and CHAINED from one packed
   state (relative RMS below 1e-2, same top-1: K4 route B), and under FAST
   with ``fused_sdpa=True`` (every K2 and K7 call held to its contract on
   its own inputs and every K1 call to equality, same top-1, relative RMS
   within ``RMS_LIMIT``); Llama-3-8B under FAST+fused and
   PACKED+packed_kv+fused (every K2/K4 and K7 call held to its contract and
   every K1 call to equality; prefill logits within ``RMS_LIMIT``; prefill
   argmax, and the greedy tokens of two prompts through the batcher, equal
   where the plain top-1/top-2 margin is at least twice the prefill logits'
   max |d|, at least one such token compared; with the admissions through
   the plain versions, the kernels' decode steps give the plain run's
   logits and tokens exactly). ``RMS_LIMIT`` lies between the relative RMS
   of the plain path with its GEMM and K7 sums in another legal order and in
   a lower-precision control, both read again in every run;
   Llama-3-8B in w4a8 under
   PACKED+fused (with K7 through its plain version on both sides, logits
   and tokens through K5 and K6 equal to the plain run's, max |d| 0; through
   every kernel, each K7 call within its contract), and in
   ``uniform_qc(8)`` under PACKED and CHAINED (bit-equal prefill and
   decode-step logits); full-width MobileNetV2 at batch 1, approx FIXED
   through K3 and its plain version (the same logits, exact sums) and FAST
   (every K2 call to its contract, every K1 call equal; the same logits,
   K2 on route A); the fused boundary against the unfused path: int8
   MobileNetV2 and ResNet-18 CHAINED against PACKED with the same top-1
   and within 4x the logits' move under a one-ulp change of every BN gamma
   (read in the same run), FP8 MobileNetV2 at batch 16 within 5e-3 with
   top-1 agreement of at least 0.9 and near ties only where it differs.

Before the last line it prints one JSON object with each kernel's launches,
error, times and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores. The float32 rate counts an FMA as two
# operations, so the CUDA cores do half as many f32 adds a second
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_ADDS_PER_S = F32_OPS_PER_S / 2
# shared memory serves 32 four-byte words a clock on each SM: K3's floor is
# one table read a product (csrc/approx_matmul.cu)
SHARED_WORDS_PER_SM_CLOCK = 32
# dense bf16 tensor-core peak: the least time for a GEMM's 2MKN operations
BF16_TC_OPS_PER_S = 989e12

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
# ViT-B/16's dense products (K2 under --fast-mode, K4 under --packed-weights)
def dense_shapes(batch):
    return [s for s in layer_shapes(batch) if s[0] != "patch_conv"]


DENSE_LAUNCHES_PER_FORWARD = 73


# ViT-B/16's bit-ops quantizer launches in one --fast-mode forward at batch
# B, one per per-tensor act or res site: (name, elements, launches)
def k1_shapes(batch):
    return [
        # the image (224*224*3 = 196*768 values a picture), the patch conv's
        # result and its site
        ("patches", 196 * batch * 768, 3),
        # per block: the two LayerNorm inputs, the q/k/v and attention-output
        # inputs and results, the context, both residual sites, the
        # intermediate input and the output result; then the embeddings,
        # encoder and final LayerNorm sites
        ("tokens", 197 * batch * 768, 12 * 15 + 3),
        # per block: the intermediate result and site, the output input
        ("mlp", 197 * batch * 3072, 12 * 3),
        ("classifier in", batch * 768, 1),
        ("classifier out", batch * 1000, 1),
    ]


K1_LAUNCHES_PER_FORWARD = sum(count for _, _, count in k1_shapes(1))
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
# the serving modes on the published flags
SERVING_FLAGS = {
    "fast": PUBLISHED_FLAGS + ["--fast-mode"],
    "packed": PUBLISHED_FLAGS + ["--fast-mode", "--packed-weights"],
    "chained": PUBLISHED_FLAGS + ["--fast-mode", "--packed-weights", "--chained-acts"],
}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def grid_operands(m, k, n, device, seed, *, ew=3, mw=4, bias_a=5, bias_b=None,
                  on_device=False):
    """Operands on their ExMy grids: activations of unit scale (bias 5) and
    lecun-scaled weights with per-column biases around 12, as calibration
    gives them at these widths. Drawn by numpy on the host, or with
    ``on_device`` by a torch generator on ``device`` (the CNN shapes reach
    200k rows)."""
    from fp8_quantization_tpu_torch.numerics.codec import quantize_exmy

    if on_device:
        gen = torch.Generator(device=device).manual_seed(seed)
        home = device
        normal = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
        ints = lambda size: torch.randint(11, 14, (size,), generator=gen,  # noqa: E731
                                          device=device, dtype=torch.int32)
    else:
        rng = np.random.default_rng(seed)
        home = "cpu"
        normal = lambda *shape: torch.from_numpy(  # noqa: E731
            rng.normal(size=shape).astype(np.float32))
        ints = lambda size: torch.from_numpy(  # noqa: E731
            rng.integers(11, 14, size=size).astype(np.int32))
    bias_b = ints(n) if bias_b is None else torch.as_tensor(bias_b, device=home)
    a = quantize_exmy(normal(m, k) * 2, ew, mw, bias_a)
    b = quantize_exmy(normal(k, n) * np.float32(k ** -0.5), ew, mw, bias_b.reshape(1, -1))
    return a.to(device), b.to(device), bias_b.to(device)


# device clock cycles of the sleep the timed runs queue behind (~50 ms)
HEAD_START_CYCLES = 100_000_000


def cuda_ms(fn, reps, head_start=HEAD_START_CYCLES):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events, after
    one warm-up run. The timed runs queue behind a device sleep of
    ``head_start`` cycles, so where the host enqueues them faster than the
    sleep lasts the events time the device's work and not the host's launch
    overhead."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(head_start)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# K3 at K = 1 over value space x value space: operand biases and a sweep
# of result biases that puts the products in every binade of the result
# grid (below half its smallest step, subnormal, normal, its top binade and
# above its max_norm)
K3_SPACE_BIASES = ((5, 3), (2, 9))
K3_SPACE_BIAS_R = tuple(range(-12, 30, 3))


def check_k3_single_products(k3, dev):
    """Every single product (K = 1) of the format's signed value space
    against the weights' value space, in the eight flag cases and the bias
    sweep: the kernel equal to its plain version bit for bit (a zero's sign
    aside, which no sum that starts at +0 keeps)."""
    from fp8_quantization_tpu_torch.numerics.codec import value_space

    calls = 0
    for i, case in enumerate(CASES):
        flags = {**FLAGSHIP, **case}
        ew, mw = flags["expo_width"], flags["mant_width"]
        for ba, bb in K3_SPACE_BIASES:
            va, vb = value_space(ew, mw, ba), value_space(ew, mw, bb)
            a = torch.cat([va, -va[1:]]).reshape(-1, 1).to(dev)
            b = torch.cat([vb, -vb[1:]]).reshape(1, -1).to(dev)
            for br in K3_SPACE_BIAS_R:
                ours = k3.approx_matmul(a, b, ba, bb, br, **flags) + 0.0
                plain = k3.approx_matmul_plain(a, b, ba, bb, br, **flags) + 0.0
                calls += 1
                if not torch.equal(ours.view(torch.int32), plain.view(torch.int32)):
                    bad = int((ours.view(torch.int32) != plain.view(torch.int32)).sum())
                    raise SystemExit(f"K3 differs from its plain version on {bad} single "
                                     f"products in case {case}, biases {ba}, {bb}, {br}")
    phase("kernels", f"K3 value space x value space at K = 1, 8 flag cases, biases "
                     f"{K3_SPACE_BIASES} x bias_r {K3_SPACE_BIAS_R[0]}..{K3_SPACE_BIAS_R[-1]}: "
                     f"equal bit for bit in {calls} calls")


def check_kernel_against_plain(k3, dev, sm_clock_hz):
    """Phase 3: returns (max_abs_err, per-forward ms / plain ms / bound ms).
    The bound is the largest of the bytes over HBM bandwidth, the products
    over the shared-memory words the SMs read a second at ``sm_clock_hz``
    (one table read a product) and the products over the f32 add rate (one
    add a product)."""
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
    # every single product of the E2M5 value space under s2nn2s, on result
    # grids low enough that nonzero products round to zero there: the zero
    # mask tests the requantized golden, as the JAX CLI's Pallas kernel does
    from fp8_quantization_tpu_torch.numerics.codec import value_space

    va, vb = value_space(2, 5, 2), value_space(2, 5, 3)
    a = torch.cat([va, -va[1:]]).reshape(-1, 1).to(dev)
    b = torch.cat([vb, -vb[1:]]).reshape(1, -1).to(dev)
    flags = {**FLAGSHIP, "expo_width": 2, "mant_width": 5, "with_s2nn2s_opt": True}
    for br in (-6, -3, 0):
        ours = k3.approx_matmul(a, b, 2, 3, br, **flags)
        plain = k3.approx_matmul_plain(a, b, 2, 3, br, **flags)
        ok = torch.equal(ours, plain)
        phase("kernels", f"K3 E2M5 value space x value space, s2nn2s, bias_r {br}: "
                         f"equal {ok}")
        if not ok:
            raise SystemExit("K3 disagrees with its plain version on the s2nn2s zero mask")
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
    check_k3_single_products(k3, dev)

    # times at the shapes of one batch-8 forward
    table_reads_per_s = (torch.cuda.get_device_properties(dev).multi_processor_count
                         * SHARED_WORDS_PER_SM_CLOCK * sm_clock_hz)
    totals = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "adds_ms": 0.0}
    for name, m, k, n, count in layer_shapes(BATCH):
        a, b, bb = grid_operands(m, k, n, dev, seed=m + k + n)
        ms = cuda_ms(lambda: k3.approx_matmul(a, b, bias_a, bb, bias_r, **FLAGSHIP), 5)
        plain_ms = cuda_ms(
            lambda: k3.approx_matmul_plain(a, b, bias_a, bb, bias_r, **FLAGSHIP), 1)
        nbytes = 4 * (m * k + k * n + m * n + n + 2)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * m * k * n / table_reads_per_s
        adds_ms = 1e3 * m * k * n / F32_ADDS_PER_S
        bound_ms = max(bytes_ms, ops_ms, adds_ms)
        phase("kernels", f"K3 {name} {m}x{k}x{n} x{count}/forward: kernel {ms:.4f} ms, "
                         f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (table reads; "
                         f"f32 adds {adds_ms:.4f}) ({m * k * n / ms / 1e6:.4g} G products/s)")
        totals["ms"] += count * ms
        totals["plain_ms"] += count * plain_ms
        totals["bytes_ms"] += count * bytes_ms
        totals["ops_ms"] += count * ops_ms
        totals["adds_ms"] += count * adds_ms
    totals["bound_ms"] = max(totals["bytes_ms"], totals["ops_ms"], totals["adds_ms"])
    totals["bound_by"] = "bytes" if totals["bytes_ms"] == totals["bound_ms"] else "operations"
    return worst, totals


def k1_inputs(rng, maxval, shape=(257, 129)):
    """Random values around ``maxval`` with zeros, f32 subnormals, +-maxval,
    the clip edges and huge values written into the first elements."""
    x = (rng.normal(size=shape) * maxval).astype(np.float32)
    edges = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-39, maxval, -maxval,
                      np.nextafter(np.float32(maxval), np.float32(0)),
                      np.nextafter(np.float32(maxval), np.float32(np.inf)),
                      -np.nextafter(np.float32(maxval), np.float32(np.inf)),
                      3e38, -3e38], np.float32)
    x.reshape(-1)[:edges.size] = edges
    return x


def check_k1(fm, dev):
    """K1 against its plain version: equal values (+-0 alike) on every
    input, per-tensor scalars on the device, sign 0 and 1."""
    from fp8_quantization_tpu_torch.numerics.fp8_ste import quantize_to_fp8_ste

    rng = np.random.default_rng(7)
    worst = 0.0
    for maxval, mant, sign in ((2.75, 4, 1), (2.75, 4, 0), (100.0, 3, 1), (0.02, 5, 1),
                               (0.0, 4, 1)):
        x = torch.from_numpy(k1_inputs(rng, maxval or 1.0)).to(dev)
        bias = quantize_to_fp8_ste(x, 8, torch.tensor([maxval], device=dev), float(mant),
                                   sign)[1].reshape(())
        for view in (x, x[:, 1:]):
            ours = fm.quantize_block(view, torch.tensor(maxval, device=dev), bias, mant, sign)
            plain = fm.quantize_block_plain(view, maxval, bias, mant, sign)
            ok = torch.equal(ours, plain)
            err = float((ours - plain).abs().nan_to_num(0.0).max())
            worst = max(worst, err)
            if not ok:
                raise SystemExit(f"K1 differs from its plain version at maxval {maxval}, "
                                 f"mant {mant}, sign {sign}")
        phase("kernels", f"K1 maxval {maxval} mant {mant} sign {sign} (bias "
                         f"{float(bias)}): equal to plain on {x.numel()} inputs, aligned "
                         "and not")
    return worst


def gemm_operands(m, k, n, dev, seed, mant=4):
    """x: (M, K) f32 of unit scale; the grid (K, N) weights of a calibrated
    per-channel E3M4 quantizer, some rows tiny (subnormal codes), with their
    per-column biases. Made on the card from ``seed``."""
    from fp8_quantization_tpu_torch.numerics.fp8_ste import quantize_to_fp8_ste

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    w[: k // 8] *= 1e-4
    wq, bias = quantize_to_fp8_ste(w, 8, w.abs().amax(dim=0, keepdim=True), float(mant), 1)
    return x, wq, bias.reshape(-1)


def device_qscalars(dev, maxval, bias, mant, sign):
    """Frozen per-tensor quantizer scalars on the card, as a calibrated site
    hands them to the kernels (no host copy inside a timed call)."""
    return (torch.tensor(float(maxval), device=dev),
            *(torch.tensor(v, dtype=torch.int32, device=dev) for v in (bias, mant, sign)))


# Phase 3 GEMM shapes (M, K, N): the four ViT-B/16 dense shapes on a 64-row
# slice (route B) and unaligned ones (13 and 3 rows: route A); Llama-3-8B's
# k/v and down projections at 1, 2, 4 and 16 decode rows and lm_head at 4
# (route A); 16 and 17 rows of 4096 x 4096, each side of the route threshold
GEMM_CHECK_SHAPES = ([(SLICE_ROWS, k, n) for k, n in SLICE_SHAPES] + [(13, 70, 29), (3, 70, 29)]
                     + [(m, 4096, 1024) for m in (1, 2, 4, 16)]
                     + [(m, 14336, 4096) for m in (1, 2, 4, 16)]
                     + [(4, 4096, 128256), (16, 4096, 4096), (17, 4096, 4096)])


def gemm_verdict(fm, ours, plain_sum, x_eff, w_eff, res=None, plain=None):
    """The GEMM contract at one call (``ours``): route A equal to the plain
    output ``plain``; route B ``fused_matmul.within_requant_step`` of the
    plain f32 sum (``res``: the requant scalars when the epilogue ran).
    Returns (route, ok, equal fraction)."""
    route = fm.gemm_route(x_eff.shape[0])
    if route == "A":
        ok = ours.dtype == plain.dtype and torch.equal(ours, plain)
        return route, ok, 1.0 if ok else 0.0
    ok, info = fm.within_requant_step(ours, plain_sum, fm.sum_tolerance(x_eff, w_eff), res)
    return route, ok and bool(torch.isfinite(ours.float()).all()), info["equal_fraction"]


def check_gemms(fm, dm, dev):
    """K2 and K4 against their plain versions in every switch combination
    (K2: f32 x quantized on the load and bf16 x; K4: bf16, f32 quantized,
    f32 and coded x; requant or not; f32 or bf16 out) at
    ``GEMM_CHECK_SHAPES``: route A (M <= 16) equal to the plain version, route
    B within ``within_requant_step``'s contract. The plain outputs are the
    plain version's f32 sum with its own requant and cast. Returns the worst
    |d| of each."""
    from fp8_quantization_tpu_torch.numerics.codec import pack_exmy, unpack_exmy

    worst = {"K2": 0.0, "K4": 0.0}
    act, res = device_qscalars(dev, 4.0, 4, 4, 1), device_qscalars(dev, 8.0, 8, 4, 1)
    x_bias = torch.tensor(3, dtype=torch.int32, device=dev)

    def cases(name, run, plain_sum, x_eff, w_eff, what, fractions):
        for requant in (False, True):
            plain_q = fm.quantize_block_plain(plain_sum, *res) if requant else plain_sum
            for out in (torch.float32, torch.bfloat16):
                ours = run(requant, out)
                route, ok, frac = gemm_verdict(fm, ours, plain_sum, x_eff, w_eff,
                                               res if requant else None, plain_q.to(out))
                worst[name] = max(worst[name], float((ours.float() - plain_q.to(out).float())
                                                     .abs().nan_to_num(0.0).max()))
                fractions.append(frac)
                if not ok:
                    raise SystemExit(f"{name} route {route} breaks its contract with its plain "
                                     f"version: {what} requant={requant} {out}")
        return route

    for m, k, n in GEMM_CHECK_SHAPES:
        x, wq, bias = gemm_operands(m, k, n, dev, seed=m + k + n)
        w16 = wq.to(torch.bfloat16)
        xq = fm.quantize_block_plain(x, *act)
        fractions = []
        for quantize_x in (True, False):
            xin = x if quantize_x else xq.to(torch.bfloat16)
            plain_sum = fm.fused_quant_matmul_plain(xin, w16, act, quantize_x=quantize_x)
            route = cases("K2", lambda rq, out: fm.fused_quant_matmul(
                xin, w16, act, res, quantize_x=quantize_x, requantize_out=rq, out_dtype=out),
                plain_sum, xq, wq, f"{m}x{k}x{n} quantize_x={quantize_x}", fractions)
        pw = dm.pack_weights(wq, bias, 3, 4)
        del w16, wq
        w_eff = dm.unpack_weights(pw)
        codes = pack_exmy(xq, 3, 4, x_bias, clip_of=True)
        forms = [("bf16 x", xq.to(torch.bfloat16), {}, xq),
                 ("f32 x quantized", x, dict(quantize_x=True, act_params=act), xq),
                 ("f32 x", x, {}, x.to(torch.bfloat16).float()),
                 ("coded x", codes, dict(x_bias=x_bias, x_expo=3, x_mant=4),
                  unpack_exmy(codes, 3, 4, x_bias))]
        for what, xin, xkw, x_eff in forms:
            kw = dict(expo_width=3, mant_width=4, **xkw)
            plain_sum = dm.dequant_matmul_plain(xin, pw.codes, pw.bias, **kw)
            cases("K4", lambda rq, out: dm.dequant_matmul(
                xin, pw.codes, pw.bias, res_params=res, requantize_out=rq, out_dtype=out, **kw),
                plain_sum, x_eff, w_eff, f"{m}x{k}x{n} {what}", fractions)
        contract = ("equal to plain" if route == "A" else
                    f"within the route B contract, min equal fraction {min(fractions):.4f}")
        phase("kernels", f"K2 (8 switch cases) and K4 (16) at {m}x{k}x{n}: route {route}, "
                         f"{contract}; worst |d| so far K2 {worst['K2']:.3g}, "
                         f"K4 {worst['K4']:.3g}")
        del x, xq, pw, w_eff, codes, forms, plain_sum
        torch.cuda.empty_cache()
    return worst


def _bound(nbytes, ops):
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / BF16_TC_OPS_PER_S
    return bytes_ms, ops_ms


def _add(totals, count, **ms):
    for key, value in ms.items():
        totals[key] = totals.get(key, 0.0) + count * value


def _finish(totals):
    totals["bound_ms"] = max(totals["bytes_ms"], totals["ops_ms"])
    totals["bound_by"] = "operations" if totals["ops_ms"] >= totals["bytes_ms"] else "bytes"
    return totals


def _timed_against_plain(name, kernel, plain, x_eff, w_eff, worst, plain_reps=1):
    """One more check of a kernel against its plain version, at a main-path
    shape: equal values (K1) or the GEMM contract (``gemm_verdict``: route A
    equal, route B within ``K * 2^-24 * sum_k |x_k w_k|``; no requant, f32
    out). Returns (kernel ms, plain ms)."""
    from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as fm

    ours, ref = kernel(), plain()
    if w_eff is None:
        ok = torch.equal(ours, ref)
    else:
        ok = gemm_verdict(fm, ours, ref, x_eff, w_eff, None, ref)[1]
    worst[name] = max(worst[name], float((ours.float() - ref.float()).abs()
                                         .nan_to_num(0.0).max()))
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version at a main-path shape")
    del ours, ref
    return cuda_ms(kernel, 5), cuda_ms(plain, plain_reps)


def time_serving_kernels(fm, dm, dev, worst):
    """K1, K2 and K4 per batch-8 forward, each at the shapes and in the
    configuration the main path launches it (K1 at every size of
    :func:`k1_shapes`; K2 on bf16 x; K4 on bf16 x as ``--packed-weights``
    and on coded x as ``--chained-acts`` runs it): held against its plain
    version once more (``worst`` takes the errors), then timed: kernel
    (CUDA events, mean of 5 after a warm-up), plain version, cuBLAS on the
    same bf16 operands (K2, K4; weights pre-decoded for K4) and the bound:
    the larger of the bytes over HBM bandwidth and 2MKN over the bf16
    tensor-core peak."""
    from fp8_quantization_tpu_torch.numerics.codec import pack_exmy, unpack_exmy

    rng = np.random.default_rng(11)
    # frozen per-tensor scalars on the device, as a calibrated site hands them
    args = (torch.tensor(3.0, device=dev),
            *(torch.tensor(v, dtype=torch.int32, device=dev) for v in (5, 4, 1)))
    k1 = {}
    for name, numel, count in k1_shapes(BATCH):
        x = torch.from_numpy(k1_inputs(rng, 3.0, shape=(numel,))).to(dev)
        ms, plain_ms = _timed_against_plain(
            "K1", lambda: fm.quantize_block(x, *args),
            lambda: fm.quantize_block_plain(x, *args), None, None, worst, plain_reps=5)
        bytes_ms, ops_ms = _bound(8 * numel, 0)
        _add(k1, count, ms=ms, plain_ms=plain_ms, bytes_ms=bytes_ms, ops_ms=ops_ms)
        phase("kernels", f"K1 {name} {numel} elements x{count}/forward: equal to plain; "
                         f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bytes_ms:.4f} ms")
    out = {"K1": _finish({**k1, "library_ms": None})}
    k2, k4, k4c = {}, {}, {}
    act = (4.0, 4, 4, 1)
    for name, m, k, n, count in dense_shapes(BATCH):
        x, wq, bias = gemm_operands(m, k, n, dev, seed=m + k + n)
        xq = fm.quantize_block_plain(x, *act)
        x16 = xq.to(torch.bfloat16)
        w16 = wq.to(torch.bfloat16)
        shape = f"{name} {m}x{k}x{n} x{count}/forward"
        ms, plain_ms = _timed_against_plain(
            "K2", lambda: fm.fused_quant_matmul(x16, w16, quantize_x=False),
            lambda: fm.fused_quant_matmul_plain(x16, w16, quantize_x=False), xq, wq, worst)
        lib_ms = cuda_ms(lambda: torch.matmul(x16, w16), 5)
        bytes_ms, ops_ms = _bound(2 * m * k + 2 * k * n + 4 * m * n, 2 * m * k * n)
        _add(k2, count, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes_ms=bytes_ms,
             ops_ms=ops_ms)
        phase("kernels", f"K2 {shape}: route {fm.gemm_route(m)}, within its contract with "
                         f"plain; kernel {ms:.4f} ms, "
                         f"plain {plain_ms:.4f} ms, cuBLAS {lib_ms:.4f} ms, bound "
                         f"{max(bytes_ms, ops_ms):.4f} ms "
                         f"({2 * m * k * n / ms / 1e9:.4g} TFLOP/s)")
        pw = dm.pack_weights(wq, bias, 3, 4)
        w_eff = dm.unpack_weights(pw)
        wd16 = w_eff.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.matmul(x16, wd16), 5)
        kw = dict(expo_width=3, mant_width=4)
        ms, plain_ms = _timed_against_plain(
            "K4", lambda: dm.dequant_matmul(x16, pw.codes, pw.bias, **kw),
            lambda: dm.dequant_matmul_plain(x16, pw.codes, pw.bias, **kw), xq, w_eff, worst)
        bytes_ms, ops_ms = _bound(2 * m * k + k * n + 4 * n + 4 * m * n, 2 * m * k * n)
        _add(k4, count, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes_ms=bytes_ms,
             ops_ms=ops_ms)
        # coded x with its packing bias on the device, as CodedFP carries it
        x_bias = torch.tensor(4, dtype=torch.int32, device=dev)
        xc = pack_exmy(xq, 3, 4, x_bias, clip_of=True)
        ckw = dict(x_bias=x_bias, x_expo=3, x_mant=4, **kw)
        coded_ms, coded_plain_ms = _timed_against_plain(
            "K4", lambda: dm.dequant_matmul(xc, pw.codes, pw.bias, **ckw),
            lambda: dm.dequant_matmul_plain(xc, pw.codes, pw.bias, **ckw),
            unpack_exmy(xc, 3, 4, x_bias), w_eff, worst)
        bytes_ms, ops_ms = _bound(m * k + k * n + 4 * n + 4 * m * n, 2 * m * k * n)
        _add(k4c, count, ms=coded_ms, plain_ms=coded_plain_ms, library_ms=lib_ms,
             bytes_ms=bytes_ms, ops_ms=ops_ms)
        phase("kernels", f"K4 {shape}: route {fm.gemm_route(m)}, within its contract with "
                         f"plain on bf16 and on coded x; kernel {ms:.4f} ms (coded x {coded_ms:.4f} ms), plain "
                         f"{plain_ms:.4f} ms (coded x {coded_plain_ms:.4f} ms), cuBLAS "
                         f"{lib_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms")
    out["K2"], out["K4"], out["K4 coded x"] = _finish(k2), _finish(k4), _finish(k4c)
    return out


def zero_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def run_serving(cli, counters, mode):
    """One serving-mode ``validate-quantized`` run, counts zeroed just
    before it. Returns (out, ms/img, counts)."""
    zero_counts(counters)
    out, ms = run_cli(cli, SERVING_FLAGS[mode])
    counts = read_counts(counters)
    phase("main", f"vit_quantized --{mode}: {out['metrics']}, {ms:.2f} ms/img over "
                  f"{out['images']} images, launches {counts}, result {out['result_file']}")
    evals = 2
    ok = (np.isfinite(out["metrics"]["loss"]) and counts["K3"] == 0 and counts["K1"] > 0
          and counts["K4"] == (0 if mode == "fast" else DENSE_LAUNCHES_PER_FORWARD * evals)
          and (mode != "fast" or (counts["K2"] == DENSE_LAUNCHES_PER_FORWARD * evals
                                  and counts["K1"] == K1_LAUNCHES_PER_FORWARD * evals)))
    if not ok:
        raise SystemExit(f"--{mode} validate-quantized: wrong launch counts or bad metrics")
    return out, ms, counts


def run_cli(cli, argv):
    args = cli.build_parser().parse_args(argv)
    out = cli.run_validate(args)
    ms_per_img = 1e3 * out["validate_s"] / out["images"]
    return out, ms_per_img


@contextlib.contextmanager
def plain_kernels():
    """Route the layers', sites' and fast path's kernels to their plain
    versions: each caller looks the wrapper up on its kernel module."""
    from fp8_quantization_tpu_torch.ops.cuda import approx_matmul as k3
    from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as dm
    from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as fm

    from fp8_quantization_tpu_torch.ops.cuda import attention as k7
    from fp8_quantization_tpu_torch.ops.cuda import decode_attention as k6

    swaps = [(fm, "quantize_block"), (fm, "fused_quant_matmul"), (k3, "approx_matmul"),
             (dm, "dequant_matmul"), (dm, "int4_matmul"), (k7, "fused_sdpa"),
             (k6, "decode_attention")]
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


# The whole-model bound of a kernel run against the plain run where K2/K4
# route B sums in the tensor cores' order (a one-step requant flip carries
# through the later sites): the relative RMS of the logits, sqrt(mean(d^2)) /
# std(plain). It lies between two readings of the plain path at the same
# seeds (PERF.md §6, PR 5: 0.027-0.032 and 0.066-0.102 on ViT-B/16 and
# Llama-3-8B at depth 2): with the GEMM sums (and K7's, whose tensor cores
# also sum in their own order) in another legal order (descending), and in a
# lower-precision control (the GEMMs' running sum rounded to bf16 after each
# CONTROL_SLICE_K-deep k-slice). Every run takes both readings again and
# fails unless they still bracket the limit.
RMS_LIMIT = 0.05
CONTROL_SLICE_K = 32   # route B's tile depth
GEMM_SUM_ORDERS = ("k descending", "bf16 running sum")


@contextlib.contextmanager
def plain_path(order):
    """``plain_kernels()``, with the K2/K4 plain versions taking their f32
    sums in ``order`` (one of ``GEMM_SUM_ORDERS``) instead of
    ``sequential_matmul``'s ascending k; in the legal order ("k
    descending") K7's plain version also sums each score over d and ``p v``
    over keys in descending order."""
    from fp8_quantization_tpu_torch.ops.cuda import attention as k7
    from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as dm
    from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as fm

    seq = fm.sequential_matmul

    def descending(a, b):
        return seq(a.flip(1), b.flip(0))

    def bf16_running(a, b):
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
        for k0 in range(0, a.shape[1], CONTROL_SLICE_K):
            part = seq(a[:, k0:k0 + CONTROL_SLICE_K], b[k0:k0 + CONTROL_SLICE_K])
            acc = (acc + part).to(torch.bfloat16).float()
        return acc

    fm.sequential_matmul = dm.sequential_matmul = dict(
        zip(GEMM_SUM_ORDERS, (descending, bf16_running)))[order]
    try:
        with plain_kernels():
            if order == GEMM_SUM_ORDERS[0]:
                k7.fused_sdpa = functools.partial(k7.fused_sdpa_plain, descending=True)
            yield
    finally:
        fm.sequential_matmul = dm.sequential_matmul = seq


def rel_rms(ours, plain):
    return float(((ours - plain) ** 2).mean().sqrt() / plain.std())


def rms_verdict(rms, forward, plain_out):
    """Holds a kernel run's relative RMS ``rms`` against the plain output
    ``plain_out`` to ``RMS_LIMIT``, after reading the same forward
    (``forward()``) through the plain path in each of ``GEMM_SUM_ORDERS``.
    Returns (ok, a line saying so)."""
    readings = []
    for order in GEMM_SUM_ORDERS:
        with plain_path(order):
            readings.append(rel_rms(forward(), plain_out))
    legal, control = readings
    ok = rms <= RMS_LIMIT and legal < RMS_LIMIT < control
    return ok, (f"relative RMS {rms:.4g} (limit {RMS_LIMIT}; plain path with the GEMM sums in "
                f"another legal order {legal:.4g}, in the lower-precision control "
                f"{control:.4g})")


def _effective_operands(kind, x, w, args, kw):
    """The bf16-valued operands a K2 (``kind`` "K2") or K4 call multiplies,
    as f32, for its sum tolerance."""
    from fp8_quantization_tpu_torch.numerics.codec import unpack_consts, unpack_exmy_bits
    from fp8_quantization_tpu_torch.numerics.rounding import to_int32
    from fp8_quantization_tpu_torch.ops.cuda.fused_matmul import quantize_block_plain

    if kind == "K2":
        act = args[0] if args else kw.get("act_params")
        xq = quantize_block_plain(x, *act) if kw.get("quantize_x", True) else x
        return xq.to(torch.bfloat16).float(), w.float()
    w_bias = args[0] if args else kw["w_bias"]
    ew, mw = kw["expo_width"], kw["mant_width"]
    web, wss = unpack_consts(to_int32(w_bias, w.device).reshape(1, -1), mw)
    w_eff = unpack_exmy_bits(w, ew, mw, web, wss, dtype=torch.bfloat16).float()
    if kw.get("x_bias") is not None:
        xeb, xss = unpack_consts(to_int32(kw["x_bias"], x.device).reshape(()), kw["x_mant"])
        x_eff = unpack_exmy_bits(x, kw["x_expo"], kw["x_mant"], xeb, xss, dtype=torch.bfloat16)
    elif kw.get("quantize_x"):
        x_eff = quantize_block_plain(x, *kw["act_params"])
    else:
        x_eff = x
    return x_eff.to(torch.bfloat16).float(), w_eff


@contextlib.contextmanager
def verified_gemms(record):
    """Every K2 and K4 call made inside goes to its kernel and is held, on
    its own inputs, to its route's contract with the plain version
    (``gemm_verdict``; the plain f32 sum without the requant is the
    reference). ``record`` gathers {"calls", "routes", "min_equal"}."""
    from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as dm
    from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as fm

    record.update(calls=0, routes=set(), min_equal=1.0)

    def wrap(kind, module, name, plain):
        kernel = getattr(module, name)

        def call(x, w, *args, **kw):
            # the wrapper counts its launches under its module-level name
            setattr(module, name, kernel)
            try:
                ours = kernel(x, w, *args, **kw)
            finally:
                setattr(module, name, call)
            ref = plain(x, w, *args, **kw)
            plain_sum = ref if not kw.get("requantize_out") and ref.dtype == torch.float32 \
                else plain(x, w, *args, **{**kw, "requantize_out": False,
                                           "out_dtype": torch.float32})
            res = None
            if kw.get("requantize_out"):
                res = args[1] if kind == "K2" and len(args) > 1 else kw.get("res_params")
            x_eff, w_eff = _effective_operands(kind, x, w, args, kw)
            route, ok, frac = gemm_verdict(fm, ours, plain_sum, x_eff, w_eff, res, ref)
            record["calls"] += 1
            record["routes"].add(route)
            record["min_equal"] = min(record["min_equal"], frac)
            if not ok:
                raise SystemExit(f"{kind} route {route} breaks its contract on a model call "
                                 f"{tuple(x.shape)} @ {tuple(w.shape)}")
            return ours
        return call

    saved = fm.fused_quant_matmul, dm.dequant_matmul
    fm.fused_quant_matmul = wrap("K2", fm, "fused_quant_matmul", fm.fused_quant_matmul_plain)
    dm.dequant_matmul = wrap("K4", dm, "dequant_matmul", dm.dequant_matmul_plain)
    try:
        yield record
    finally:
        fm.fused_quant_matmul, dm.dequant_matmul = saved


@contextlib.contextmanager
def verified_attention(record):
    """Every K7 and K1 call made inside goes to its kernel and is held, on
    its own inputs, to its plain version: K7 to its contract
    (``attention.within_sdpa_contract``), K1 equal bit for bit. ``record``
    gathers {"K7", "K1" (calls), "min_equal", "worst_ratio"}."""
    from fp8_quantization_tpu_torch.ops.cuda import attention as k7
    from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as fm

    record.update(K7=0, K1=0, min_equal=1.0, worst_ratio=0.0)
    contract_kw = ("s_valid", "causal", "offsets", "res_params", "requantize_out")

    def run(module, name, kernel, call, *args, **kw):
        # the wrapper counts its launches under its module-level name
        setattr(module, name, kernel)
        try:
            return kernel(*args, **kw)
        finally:
            setattr(module, name, call)

    sdpa, quantize = k7.fused_sdpa, fm.quantize_block

    def sdpa_call(q, k, v, **kw):
        ours = run(k7, "fused_sdpa", sdpa, sdpa_call, q, k, v, **kw)
        info = _sdpa_verdict(f"K7 on a model call {tuple(q.shape)} over {tuple(k.shape)}",
                             ours, q, k, v, **{key: kw[key] for key in contract_kw if key in kw})
        record["K7"] += 1
        record["min_equal"] = min(record["min_equal"], info["equal_fraction"])
        record["worst_ratio"] = max(record["worst_ratio"], info.get("worst_ratio", 0.0))
        return ours

    def quantize_call(x, *args):
        ours = run(fm, "quantize_block", quantize, quantize_call, x, *args)
        record["K1"] += 1
        if not torch.equal(ours, fm.quantize_block_plain(x, *args)):
            raise SystemExit(f"K1 differs from its plain version on a model call {tuple(x.shape)}")
        return ours

    k7.fused_sdpa, fm.quantize_block = sdpa_call, quantize_call
    try:
        yield record
    finally:
        k7.fused_sdpa, fm.quantize_block = sdpa, quantize


def compare_logits(name, logits, plain_logits, spec, close=False):
    """Equal top-1 and ``max|d| <= 1e-5 * max(1, max|logit|)``; with
    ``close`` (paths through K2/K4 route B, whose tensor cores sum in their
    own order) equal top-1 and a relative RMS below 1e-2."""
    logits, plain_logits = logits.float(), plain_logits.float()
    diff = float((logits - plain_logits).abs().max())
    scale = float(plain_logits.abs().max())
    rel = rel_rms(logits, plain_logits)
    same_top1 = bool((logits.argmax(-1) == plain_logits.argmax(-1)).all())
    near = rel < 1e-2 if close else diff <= 1e-5 * max(1.0, scale)
    ok = (tuple(logits.shape) == (1, spec.num_classes)
          and bool(torch.isfinite(logits).all()) and near and same_top1)
    phase("model", f"{name}, width {spec.hidden_size}, depth {spec.num_layers}, batch 1: "
                   f"max|kernel - plain| = {diff:.3g} (max|logit| {scale:.3g}), relative RMS "
                   f"{rel:.3g}, same top-1 {same_top1}, ok={ok}")
    if not ok:
        raise SystemExit(f"{name}: whole-model logits through the kernels and their "
                         "plain versions disagree")


def calibrated_model(cli, argv, dev, spec):
    from fp8_quantization_tpu_torch.eval.data import synthetic_batches
    from fp8_quantization_tpu_torch.eval.driver import calibrate
    from fp8_quantization_tpu_torch.models.vit import QuantizedViT

    qc = cli.config_from_args(cli.build_parser().parse_args(argv))
    model = QuantizedViT(qc=qc, spec=spec,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    (x, _), = synthetic_batches(1, 1, image_size=spec.image_size,
                                num_classes=spec.num_classes, seed=3)
    calibrate(model, [x], num_est_batches=1)
    return model, qc, torch.from_numpy(x).to(dev)


def check_model(cli, argv, dev, spec):
    """Phase 5: logits of the approximate ViT through K3 and through its
    plain version, from one calibrated state."""
    from fp8_quantization_tpu_torch.quant.sites import FIXED

    model, _, xt = calibrated_model(cli, argv, dev, spec)
    with torch.no_grad():
        logits = model(xt, FIXED)
        with plain_kernels():
            plain_logits = model(xt, FIXED)
    # every approximate partial product is requantized onto the result grid,
    # so each is a multiple of 2^(1 - bias_r - M) and the f32 sums over K are
    # exact in any order at these magnitudes: the two agree to rounding
    compare_logits("approx FIXED", logits, plain_logits, spec)


def check_serving_model(cli, dev, spec, counters):
    """Phase 5: the published-flag ViT calibrated, cached and packed once,
    then PACKED and CHAINED logits through the kernels (K1, K4) and through
    their plain versions. At batch 1 (M = 197) K4 takes route B, whose
    tensor cores sum in their own order: equal top-1 and a relative RMS
    below 1e-2 (``compare_logits(close=True)``)."""
    from fp8_quantization_tpu_torch.eval.driver import cache_quantized_weights
    from fp8_quantization_tpu_torch.ops.fastpath import pack_dense_caches
    from fp8_quantization_tpu_torch.quant.sites import CHAINED, PACKED

    model, qc, xt = calibrated_model(cli, PUBLISHED_FLAGS, dev, spec)
    size = spec.image_size
    cache_quantized_weights(model, torch.zeros((1, size, size, 3), device=dev), fast=True)
    _, report = pack_dense_caches(model, qc)
    dense = 6 * spec.num_layers + 1
    phase("model", f"packed {len(report)} layers, bit-exact channel fraction "
                   f"{min(report.values()):.3f}..{max(report.values()):.3f}")
    for name, qp in (("PACKED", PACKED), ("CHAINED", CHAINED)):
        with torch.no_grad():
            zero_counts(counters)
            logits = model(xt, qp)
            counts = read_counts(counters)
            with plain_kernels():
                plain_logits = model(xt, qp)
        if counts["K4"] != dense or counts["K1"] == 0 or read_counts(counters) != counts:
            raise SystemExit(f"{name}: launches {counts} (expected K4 {dense}, some K1; "
                             "none from the plain versions)")
        compare_logits(f"{name} (launches {counts})", logits, plain_logits, spec, close=True)


# ---------------------------------------------------------------------------
# Llama-3-8B serving with ContinuousBatcher (scripts/bench_llama.py's FP8
# configuration and calibrate-then-serve sequence)

LLAMA_PROMPTS = (17, 100, 256, 511)
LLAMA_LATE_PROMPT = 64
LLAMA_NEW_TOKENS = 32
LLAMA_SLOTS = 4
LLAMA_MAX_SEQ = 2048
# device clock cycles of the sleep ahead of the microsecond attention kernels
SHORT_HEAD_START = 10_000_000


def llama_qc():
    """``scripts/bench_llama.py::fp8_qc``: E3M4, per-channel current-minmax
    weights, allminmax acts, quantize-input, res-quantizer with
    ``original_quantize_res``."""
    from fp8_quantization_tpu_torch import config as tc

    return tc.QuantConfig(
        method=tc.QMethod.fp_quantizer, per_channel_weights=True, quantize_input=True,
        weight_range=tc.EstimatorConfig(tc.RangeMethod.current_minmax),
        act_range=tc.EstimatorConfig(tc.RangeMethod.allminmax),
        fp8=tc.FP8Config(set_maxval=True, mse_include_mantissa_bits=False),
        run_method=tc.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True))


def llama_w4a8_qc():
    """``scripts/bench_llama_big.py::int4_qc``: symmetric uniform 4-bit
    per-channel current-minmax weights, 8-bit allminmax acts,
    quantize-input, res-quantizer."""
    from fp8_quantization_tpu_torch import config as tc

    return tc.QuantConfig(
        method=tc.QMethod.symmetric_uniform, n_bits=4, n_bits_act=8,
        per_channel_weights=True, quantize_input=True,
        weight_range=tc.EstimatorConfig(tc.RangeMethod.current_minmax),
        act_range=tc.EstimatorConfig(tc.RangeMethod.allminmax),
        run_method=tc.RunMethodConfig(res_quantizer_flag=True))


def llama_int8_qc():
    """``scripts/bench_llama.py::uniform_qc(8)``: the w4a8 configuration at
    8 bits throughout."""
    return dataclasses.replace(llama_w4a8_qc(), n_bits=8, n_bits_act=None)


def llama_dense_shapes(spec):
    """(name, K, N, launches per forward) of a Llama forward's projections."""
    h, layers = spec.hidden_size, spec.num_layers
    return [("q/o_proj", h, spec.num_heads * spec.head_dim, 2 * layers),
            ("k/v_proj", h, spec.num_kv_heads * spec.head_dim, 2 * layers),
            ("gate/up_proj", h, spec.mlp_dim, 2 * layers),
            ("down_proj", spec.mlp_dim, h, layers),
            ("lm_head", h, spec.vocab_size, 1)]


def llama_k1_per_forward(spec):
    """K1 launches of one serving forward: the act and res sites of the
    seven projections and the K and V cache sites of every layer, and the
    act and res sites of ``lm_head``."""
    return spec.num_layers * (7 * 2 + 2) + 2


def llama_dense_per_forward(spec):
    return 7 * spec.num_layers + 1


def calibrated_llama(spec, dev, seed, qc=None):
    """Seeded random weights made on the card, then ``calibrate_llama``:
    an ESTIMATE forward of a (2, 16) calibration batch and a FAST
    ``cache_weights`` forward. ``qc`` defaults to the FP8 configuration."""
    from fp8_quantization_tpu_torch.models.llama import QuantizedLlama
    from fp8_quantization_tpu_torch.models.serving import calibrate_llama

    model = QuantizedLlama(qc or llama_qc(), spec, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    calibrate_llama(model, np.random.default_rng(10).integers(0, spec.vocab_size, (2, 16)))
    return model


def llama_prompts(spec):
    rng = np.random.default_rng(20)
    return [rng.integers(0, spec.vocab_size, size=n).tolist()
            for n in LLAMA_PROMPTS + (LLAMA_LATE_PROMPT,)]


def serving_phase(packed):
    from fp8_quantization_tpu_torch.quant.sites import QuantPhase

    return QuantPhase(phase="fixed", fast=True, packed=packed, fused_sdpa=True)


def serve_llama(name, model, spec, qp, counters, dev, per_forward):
    """Phase 4: the four prompts, then the fifth into the first slot that
    retires, 32 greedy tokens each, with every launch count zeroed just
    before; the counts must be the ones the run's shapes imply: K7 once a
    layer per admission, K6 once a layer per step, ``per_forward`` (kernel
    -> launches) per forward and no other kernel. Returns the run's record:
    stats, counts and the shapes the kernels saw."""
    from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher, _pad_to_bucket

    prompts = llama_prompts(spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    batcher = ContinuousBatcher(model, spec, slots=LLAMA_SLOTS, max_seq=LLAMA_MAX_SEQ, qp=qp)
    run = {"prefill_s": 0.0, "prefill_tokens": 0, "step_s": [], "step_tokens": 0,
           "chunks": [], "step_lengths": [], "outputs": {}}
    zero_counts(counters)

    def admit(prompt):
        t0 = time.perf_counter()
        slot = batcher.admit(prompt, max_new_tokens=LLAMA_NEW_TOKENS)   # reads a token: syncs
        run["prefill_s"] += time.perf_counter() - t0
        run["prefill_tokens"] += len(prompt)
        run["chunks"].append(_pad_to_bucket(len(prompt)))
        return slot

    owner = {admit(p): i for i, p in enumerate(prompts[:-1])}
    late = prompts[-1]
    while True:
        lengths = batcher.cache.length.tolist()
        t0 = time.perf_counter()
        out = batcher.step()                                            # reads tokens: syncs
        if not out:
            break
        run["step_s"].append(time.perf_counter() - t0)
        run["step_tokens"] += len(out)
        run["step_lengths"].append(lengths)
        for slot in [s for s, st in batcher.active.items() if st["done"]]:
            run["outputs"][owner.pop(slot)] = batcher.retire(slot)
            if late is not None:
                owner[admit(late)] = len(prompts) - 1
                late = None
    counts = read_counts(counters)
    run["counts"] = counts
    run["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    steps, admissions = len(run["step_s"]), len(run["chunks"])
    forwards = steps + admissions
    expected = {key: 0 for key in counters}
    expected.update({key: n * forwards for key, n in per_forward.items()})
    expected.update(K6=spec.num_layers * steps, K7=spec.num_layers * admissions)
    outputs = run["outputs"]
    ok = (counts == expected and sorted(outputs) == list(range(len(prompts)))
          and all(len(o) == LLAMA_NEW_TOKENS and all(0 <= t < spec.vocab_size for t in o)
                  for o in outputs.values()))
    run["prefill_tok_s"] = run["prefill_tokens"] / run["prefill_s"]
    run["decode_tok_s"] = run["step_tokens"] / sum(run["step_s"])
    run["step_ms_median"] = 1e3 * float(np.median(run["step_s"]))
    phase("main", f"Llama-3-8B {name}: {admissions} admissions ({run['prefill_tokens']} "
                  f"prompt tokens, chunks {run['chunks']}), {steps} decode steps "
                  f"({run['step_tokens']} tokens); prefill {run['prefill_tok_s']:.1f} tok/s, "
                  f"decode {run['decode_tok_s']:.2f} tok/s, median step "
                  f"{run['step_ms_median']:.2f} ms, peak memory {run['peak_gb']:.2f} GB; "
                  f"launches {counts} (expected {expected}); first tokens "
                  f"{[outputs[i][:4] for i in sorted(outputs)]}; ok={ok}")
    if not ok:
        raise SystemExit(f"Llama {name} serving: wrong launch counts or outputs")
    return run


def profile_decode(name, model, spec, qp, dev, steps=3):
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    steps of a batcher holding the four prompts (after one unprofiled step).
    Prints the wall and device time per step, the device's busy share, the
    kernel launches per step and the heaviest kernels. The profiler's own
    host cost inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher

    batcher = ContinuousBatcher(model, spec, slots=LLAMA_SLOTS, max_seq=LLAMA_MAX_SEQ, qp=qp)
    for prompt in llama_prompts(spec)[:-1]:
        batcher.admit(prompt, max_new_tokens=LLAMA_NEW_TOKENS)
    batcher.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            batcher.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = sorted((e for e in prof.key_averages() if device_us(e) > 0), key=device_us,
                     reverse=True)
    busy_us = sum(device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top = "; ".join(f"{e.key[:40]} {device_us(e) / 1e3 / steps:.2f} ms x{e.count // steps}"
                    for e in kernels[:6])
    phase("main", f"Llama-3-8B {name} decode step, profiled over {steps} steps at 4 live "
                  f"slots: wall {1e3 * wall / steps:.2f} ms, device {busy_us / 1e3 / steps:.2f} "
                  f"ms (busy share {busy_us / 1e6 / wall:.3f}), {launches // steps} kernel "
                  f"launches per step; heaviest: {top}")


def _sdpa_verdict(name, ours, q, k, v, **kw):
    """K7's contract at one call (``attention.within_sdpa_contract``): fails
    the run when it breaks it; returns the contract's record (equal fraction,
    max |d| against the plain output, worst ratio of |d| to the bound for an
    f32 output without requant)."""
    from fp8_quantization_tpu_torch.ops.cuda import attention as k7

    ok, info = k7.within_sdpa_contract(ours, q, k, v, **kw)
    if not ok:
        raise SystemExit(f"{name} breaks its contract with its plain version: {info}")
    return info


def _equal_decode(name, ours, plain):
    """K6 equal to its plain version bit for bit; returns max|d| (0)."""
    if not (torch.equal(ours, plain) and bool(torch.isfinite(ours).all())):
        raise SystemExit(f"K6 {name}: {int((ours != plain).sum())} of {ours.numel()} outputs "
                         f"differ from the plain version, max|d| "
                         f"{float((ours - plain).abs().max()):.3g}")
    return 0.0


def _randn(gen, *shape, dev):
    return torch.randn(shape, generator=gen, device=dev)


def _sdpa_bound(b, t, s, h, hk, d, pairs):
    """K7's bound: q, k, v read once as bf16 and the f32 context written
    once, against 2 x 2 x D operations per unmasked (query token, key) pair
    of the function (``pairs``, over the batch and per query head: q k^T and
    p v)."""
    return _bound(2 * b * t * h * d + 2 * 2 * b * s * hk * d + 4 * b * t * h * d,
                  2 * 2 * h * d * pairs)


# ViT-B/16's attention: one K7 launch a block, batch 8 (B, T, H, D)
VIT_ATTENTION = (BATCH, 197, 12, 64)
VIT_LAYERS = 12


def check_attention(spec, dev):
    """Phase 3: K7 held to its contract and K6 to bit equality with their
    plain versions at the shapes the serving run does not give them
    (``time_llama_attention`` checks the cold chunks and decode lengths it
    does give): K7 on a warm slab with offsets, ViT-B/16 (timed there per
    batch-8 forward: kernel, plain, SDPA, bound) and an unaligned shape, each
    also with the requant epilogue, which must equal K1 of the kernel's own
    context; K6 in bf16 and codes at lengths on its 64-key sub-chunk and
    512-key block edges, up to the full slab, and at an S that is not a
    multiple of 512. Returns the worst max|d| of each and K7's ViT times."""
    from fp8_quantization_tpu_torch.numerics.codec import pack_exmy
    from fp8_quantization_tpu_torch.ops.cuda import attention as k7
    from fp8_quantization_tpu_torch.ops.cuda import decode_attention as k6
    from fp8_quantization_tpu_torch.ops.cuda.fused_matmul import quantize_block_plain

    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {"K6": 0.0, "K7": 0.0}
    h, hk, d = spec.num_heads, spec.num_kv_heads, spec.head_dim
    vb, vt, vh, vd = VIT_ATTENTION
    cases = [("Llama warm slab S=2048 with offsets", (4, 16, 2048, h, hk, d),
              dict(causal=True, offsets=[0, 100, 1000, 2032])),
             ("ViT-B/16 batch 8", (vb, vt, vt, vh, vh, vd), dict(s_valid=vt)),
             ("unaligned", (2, 37, 53, 6, 2, 40), dict(s_valid=45))]
    res = (torch.tensor(2.0, device=dev), torch.tensor(5, dtype=torch.int32, device=dev), 4, 1)
    vit = None
    for name, (b, t, s, nh, nk, hd), kw in cases:
        q = _randn(gen, b, t, nh, hd, dev=dev).to(torch.bfloat16)
        k, v = (_randn(gen, b, s, nk, hd, dev=dev).to(torch.bfloat16) for _ in range(2))
        if "offsets" in kw:
            kw = {**kw, "offsets": torch.tensor(kw["offsets"], dtype=torch.int32, device=dev)}
        ours = k7.fused_sdpa(q, k, v, **kw)
        info = _sdpa_verdict(f"K7 {name}", ours, q, k, v, **kw)
        worst["K7"] = max(worst["K7"], info["max_abs"])
        requant = k7.fused_sdpa(q, k, v, res_params=res, **kw)
        if not torch.equal(requant, quantize_block_plain(ours, *res)):
            raise SystemExit(f"K7 {name}: the requant epilogue is not K1 of its context")
        rinfo = _sdpa_verdict(f"K7 {name} with requant", requant, q, k, v, res_params=res, **kw)
        phase("kernels", f"K7 {name} q {tuple(q.shape)} kv {tuple(k.shape)} {sorted(kw)}: "
                         f"within its contract, {info['equal_fraction']:.4f} of outputs equal "
                         f"to plain, worst |d| / bound {info['worst_ratio']:.3g}, max|d| "
                         f"{info['max_abs']:.3g}; requant epilogue equal to K1 of the context "
                         f"and within its contract ({rinfo['equal_fraction']:.4f} equal)")
        if name.startswith("ViT"):
            ms = cuda_ms(lambda: k7.fused_sdpa(q, k, v, **kw), 5, SHORT_HEAD_START)
            plain_ms = cuda_ms(lambda: k7.fused_sdpa_plain(q, k, v, **kw), 1)
            lib_ms = cuda_ms(lambda: _sdpa_library(q, k, v), 5, SHORT_HEAD_START)
            bytes_ms, ops_ms = _sdpa_bound(b, t, s, nh, nk, hd, b * t * s)
            vit = {}
            _add(vit, VIT_LAYERS, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                 bytes_ms=bytes_ms, ops_ms=ops_ms)
            vit = _finish(vit)
            vit["launches"] = VIT_LAYERS
            phase("kernels", f"K7 ViT-B/16 per batch-8 forward ({VIT_LAYERS} launches): kernel "
                             f"{vit['ms']:.4f} ms, plain {vit['plain_ms']:.4f} ms, SDPA "
                             f"{vit['library_ms']:.4f} ms, bound {vit['bound_ms']:.4f} ms "
                             f"({vit['bound_by']})")
    for b, s, lengths in ((4, 2048, [1, 100, 1000, 2048]), (7, 640, [1, 63, 64, 65, 511, 512, 513]),
                          (3, 700, [1, 513, 700])):
        q = _randn(gen, b, h, d, dev=dev)
        kf, vf = (_randn(gen, b, s, hk, d, dev=dev) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kb, vb = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (4, 5))
        forms = [("bf16", kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}),
                 ("uint8 codes", pack_exmy(kf, 3, 4, kb, clip_of=True),
                  pack_exmy(vf, 3, 4, vb, clip_of=True),
                  dict(k_bias=kb, v_bias=vb, kv_expo=3, kv_mant=4))]
        for form, ks, vs, kw in forms:
            _equal_decode(f"{form} S={s} lengths {lengths}",
                          k6.decode_attention(q, ks, vs, lens, **kw),
                          k6.decode_attention_plain(q, ks, vs, lens, **kw))
            phase("kernels", f"K6 {form} B={b} S={s} H={h} HK={hk} D={d} lengths {lengths}: "
                             f"equal to plain bit for bit")
    return worst, vit


def _sdpa_library(q, k, v, **kw):
    """``scaled_dot_product_attention`` on head-major views of the same bf16
    operands (the yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), enable_gqa=True, **kw)


def time_llama_attention(spec, dev, run, coded, worst):
    """K7 at every admission chunk and K6 at every decode step's lengths of
    one serving run, held against their plain versions once more (K7 to its
    contract, K6 bit for bit) and timed on seeded operands of those shapes:
    kernel (CUDA events, mean of 3-5 after a warm-up), plain version (1 run),
    ``scaled_dot_product_attention`` on the same bf16 operands (K6 on the
    decoded slab, with the length mask) and the bound (K7: ``_sdpa_bound``;
    K6: the K and V bytes below each length, q and out, against 2 x 2 x D
    operations per (query head, key)). Totals are per run: each shape's times
    x the layers; K6 also per decode step. K7 only for the bf16 run (the
    packed run's chunks are the same)."""
    from fp8_quantization_tpu_torch.numerics.codec import pack_exmy, unpack_exmy
    from fp8_quantization_tpu_torch.ops.cuda import attention as k7
    from fp8_quantization_tpu_torch.ops.cuda import decode_attention as k6

    gen = torch.Generator(device=dev).manual_seed(5)
    h, hk, d, layers = spec.num_heads, spec.num_kv_heads, spec.head_dim, spec.num_layers
    out = {}
    if not coded:
        k7t = {}
        for t in run["chunks"]:
            q = _randn(gen, 1, t, h, d, dev=dev).to(torch.bfloat16)
            k, v = (_randn(gen, 1, t, hk, d, dev=dev).to(torch.bfloat16) for _ in range(2))
            info = _sdpa_verdict(f"K7 T={t}", k7.fused_sdpa(q, k, v, causal=True), q, k, v,
                                 causal=True)
            worst["K7"] = max(worst["K7"], info["max_abs"])
            ms = cuda_ms(lambda: k7.fused_sdpa(q, k, v, causal=True), 5, SHORT_HEAD_START)
            plain_ms = cuda_ms(lambda: k7.fused_sdpa_plain(q, k, v, causal=True), 1)
            lib_ms = cuda_ms(lambda: _sdpa_library(q, k, v, is_causal=True), 5, SHORT_HEAD_START)
            bytes_ms, ops_ms = _sdpa_bound(1, t, t, h, hk, d, t * (t + 1) // 2)
            _add(k7t, layers, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes_ms=bytes_ms,
                 ops_ms=ops_ms)
            flops = 3 * 2 * h * d * t * (t + 1) // 2
            phase("kernels", f"K7 Llama chunk T={t} x{layers}/admission: within its contract, "
                             f"{info['equal_fraction']:.4f} equal to plain, worst |d| / bound "
                             f"{info['worst_ratio']:.3g}; kernel {ms:.4f} ms "
                             f"({flops / ms / 1e9:.4g} TFLOP/s of its three dots), plain "
                             f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
                             f"{max(bytes_ms, ops_ms):.4f} ms")
        out["K7"] = _finish(k7t)
    b, s = LLAMA_SLOTS, LLAMA_MAX_SEQ
    q = _randn(gen, b, h, d, dev=dev)
    kf, vf = (_randn(gen, b, s, hk, d, dev=dev) for _ in range(2))
    if coded:
        kb, vb = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (4, 5))
        ks, vs = pack_exmy(kf, 3, 4, kb, clip_of=True), pack_exmy(vf, 3, 4, vb, clip_of=True)
        kw = dict(k_bias=kb, v_bias=vb, kv_expo=3, kv_mant=4)
        k16 = unpack_exmy(ks, 3, 4, kb, dtype=torch.bfloat16)
        v16 = unpack_exmy(vs, 3, 4, vb, dtype=torch.bfloat16)
        eb = 1
    else:
        ks, vs, kw = kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}
        k16, v16, eb = ks, vs, 2
    q16 = q.to(torch.bfloat16)[:, None]
    pos = torch.arange(s, device=dev)
    k6t = {}
    for lengths in run["step_lengths"]:
        lens = torch.tensor([n + 1 for n in lengths], dtype=torch.int32, device=dev)
        mask = (pos[None, :] < lens[:, None])[:, None, None, :]
        worst["K6"] = max(worst["K6"], _equal_decode(
            f"step lengths {lengths}", k6.decode_attention(q, ks, vs, lens, **kw),
            k6.decode_attention_plain(q, ks, vs, lens, **kw)))
        ms = cuda_ms(lambda: k6.decode_attention(q, ks, vs, lens, **kw), 3, SHORT_HEAD_START)
        plain_ms = cuda_ms(lambda: k6.decode_attention_plain(q, ks, vs, lens, **kw), 1)
        lib_ms = cuda_ms(lambda: _sdpa_library(q16, k16, v16, attn_mask=mask), 3,
                         SHORT_HEAD_START)
        keys = sum(min(n + 1, s) for n in lengths)
        bytes_ms, ops_ms = _bound(2 * eb * keys * hk * d + 2 * 4 * b * h * d + 4 * b,
                                  2 * 2 * h * d * keys)
        _add(k6t, layers, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes_ms=bytes_ms,
             ops_ms=ops_ms)
    out["K6"] = t6 = _finish(k6t)
    steps = len(run["step_lengths"])
    t6["per_decode_step"] = {"launches": layers, "bound_by": t6["bound_by"],
                             **{f: t6[f] / steps for f in ("ms", "bound_ms", "library_ms")}}
    phase("kernels", f"K6 ({'uint8 codes' if coded else 'bf16'}) over the run's {steps} decode "
                     f"steps x{layers} layers, each step equal to plain bit for bit: kernel "
                     f"{t6['ms']:.3f} ms ({1e3 * t6['ms'] / (steps * layers):.2f} us/launch, "
                     f"{t6['per_decode_step']['ms']:.4f} ms/step), plain {t6['plain_ms']:.3f} ms, "
                     f"SDPA {t6['library_ms']:.3f} ms ({t6['per_decode_step']['library_ms']:.4f} "
                     f"ms/step), bound {t6['bound_ms']:.3f} ms ({t6['bound_by']})")
    return out


# the dense int8 tensor-core peak of the H100 SXM data sheet: the least time
# for an integer GEMM's 2MKN operations
INT8_TC_OPS_PER_S = 1979e12
# K5 in phase 3: Llama-3-8B's decode projections (k/v, gate/up, down) and
# lm_head at M = 4 slots, a 512-token prefill chunk, both sides of the route
# edge (M = 16 / 17), and shapes with odd K and M, N off any tile (the byte
# loads of rows that are not 16-byte aligned) on both routes
K5_SHAPES = ((4, 4096, 1024), (4, 4096, 14336), (4, 14336, 4096), (4, 4096, 128256),
             (512, 4096, 14336), (16, 4096, 4096), (17, 4096, 4096), (9, 97, 136),
             (3, 4097, 1000), (40, 4097, 1000))


def int4_operands(gen, m, k, n, dev):
    """x codes over the full int8 range, w codes over [-8, 7] (their
    extremes in the first row and column), the nibble-packed w, and w as
    int8 for the library call."""
    from fp8_quantization_tpu_torch.ops.fastpath import pack_int4

    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int8)
    x[0] = -128
    w[:, 0] = -8
    return x, pack_int4(w), w


def _int_mm_library(x, w):
    """``torch._int_mm`` of the same codes (the yardstick; the port calls it
    only for the int8 layers' product): it takes more than 16 rows and K, N
    multiples of 8, so x is padded to 32 rows and K, N to multiples of 8
    ahead of the timed call. Returns the callable, or None where it cannot
    run."""
    m, k = x.shape
    n = w.shape[1]
    if k % 8 or n % 8:
        return None
    xp = torch.nn.functional.pad(x, (0, 0, 0, max(32, m) - m)) if m <= 16 else x
    return lambda: torch._int_mm(xp, w)


def time_k5(dm, dev, gen, m, k, n, w=None):
    """K5 at one shape against its plain version (equal, max |d| 0), then
    timed: kernel (CUDA events, mean of 5 after a warm-up), plain (1 run),
    ``torch._int_mm`` on the unpacked codes and the bound, the larger of
    (M K + ceil(K/2) N + 4 M N) bytes over HBM bandwidth and 2 M K N over the
    int8 tensor-core peak. ``w`` reuses (w4, w int8) of this (K, N)."""
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    x[0] = -128
    if w is None:
        _, w4, w8 = int4_operands(gen, 1, k, n, dev)
    else:
        w4, w8 = w
    ours = dm.int4_matmul(x, w4, k=k)
    plain = dm.int4_matmul_plain(x, w4, k=k)
    if not torch.equal(ours, plain):
        err = int((ours.long() - plain.long()).abs().max())
        raise SystemExit(f"K5 differs from its plain version at {m}x{k}x{n}: max|d| {err}")
    del ours, plain
    ms = cuda_ms(lambda: dm.int4_matmul(x, w4, k=k), 5, SHORT_HEAD_START)
    plain_ms = cuda_ms(lambda: dm.int4_matmul_plain(x, w4, k=k), 1)
    lib = _int_mm_library(x, w8)
    lib_ms = cuda_ms(lib, 5, SHORT_HEAD_START) if lib is not None else None
    bytes_ms = 1e3 * (m * k + -(-k // 2) * n + 4 * m * n) / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2 * m * k * n / INT8_TC_OPS_PER_S
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes_ms=bytes_ms, ops_ms=ops_ms)


def check_k5(dm, dev):
    """Phase 3: K5 equal to its plain version at Llama-3-8B's shapes, the
    route edge and unaligned ones, each timed beside its plain version,
    ``torch._int_mm`` and the bound."""
    from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as fm

    gen = torch.Generator(device=dev).manual_seed(9)
    for m, k, n in K5_SHAPES:
        t = time_k5(dm, dev, gen, m, k, n)
        lib = f"{t['library_ms']:.4f}" if t["library_ms"] is not None else "n/a (K, N not 8-aligned)"
        phase("kernels", f"K5 {m}x{k}x{n} route {fm.gemm_route(m)}: equal to plain (max|d| 0); "
                         f"kernel {t['ms']:.4f} ms, "
                         f"plain {t['plain_ms']:.4f} ms, torch._int_mm {lib} ms, bound "
                         f"{max(t['bytes_ms'], t['ops_ms']):.4f} ms "
                         f"({2 * m * k * n / t['ms'] / 1e9:.4g} TOP/s)")


def time_llama_k5(spec, dev, run, worst):
    """K5 at every shape one w4a8 serving run gave it: each projection at
    M = each admission's chunk and at M = 4 slots per decode step, held
    against its plain version once more and timed (``time_k5``). Totals are
    per run: each shape's times x its launches in the run."""
    from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as dm

    gen = torch.Generator(device=dev).manual_seed(6)
    chunks = {}
    for t in run["chunks"]:
        chunks[t] = chunks.get(t, 0) + 1
    steps = len(run["step_s"])
    rows = dict(chunks)
    rows[LLAMA_SLOTS] = rows.get(LLAMA_SLOTS, 0) + steps
    total, per_step, prefill = {}, {}, {}
    for name, k, n, per_forward in llama_dense_shapes(spec):
        _, w4, w8 = int4_operands(gen, 1, k, n, dev)
        for m, forwards in sorted(rows.items()):
            t = time_k5(dm, dev, gen, m, k, n, w=(w4, w8))
            _add(total, forwards * per_forward, **t)
            if m in chunks:
                _add(prefill, chunks[m] * per_forward, **t)
            if m == LLAMA_SLOTS:
                _add(per_step, per_forward, **t)
        del w4, w8
        torch.cuda.empty_cache()
    phase("kernels", f"K5 equal to plain at every (M, K, N) of the w4a8 run: M in "
                     f"{sorted(rows)} x {len(llama_dense_shapes(spec))} projections")
    pre = _finish(prefill)
    phase("kernels", f"K5 over the run's admissions (chunks {sorted(chunks)}): kernel "
                     f"{pre['ms']:.3f} ms, plain {pre['plain_ms']:.3f} ms, torch._int_mm "
                     f"{pre['library_ms']:.3f} ms, bound {pre['bound_ms']:.3f} ms "
                     f"({pre['bound_by']})")
    worst["K5"] = 0.0   # time_k5 stops the run at any difference
    step = _finish(per_step)
    phase("kernels", f"K5 per decode step (M={LLAMA_SLOTS}, {llama_dense_per_forward(spec)} "
                     f"launches): kernel "
                     f"{step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, torch._int_mm "
                     f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms "
                     f"({step['bound_by']})")
    out = _finish(total)
    phase("kernels", f"K5 over the w4a8 run ({sum(rows.values())} forwards, M in "
                     f"{sorted(rows)}): kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, "
                     f"torch._int_mm {out['library_ms']:.3f} ms, bound {out['bound_ms']:.3f} ms "
                     f"({out['bound_by']})")
    return out


def time_llama_gemms(spec, dev, run, worst):
    """K2 (FAST: f32 x quantized on the load) and K4 (PACKED: bf16 x) at
    each Llama-3-8B projection shape, at M = 4 slots (decode, route A) and
    at M = each admission chunk of the FAST run (prefill, route B): held
    against the plain version once per shape (``gemm_verdict``), then timed
    (CUDA events, mean of 5 after a warm-up) beside ``torch.matmul`` on the
    same bf16 operands (the yardstick; the port never calls it) and the
    bound, the larger of the bytes over HBM bandwidth (K2: f32 x, bf16 w;
    K4: bf16 x, 1-byte codes and (N,) biases; f32 out) and 2 M K N over the
    bf16 tensor-core peak. Returns ``{"K2": {...}, "K4": {...}}``, each with
    ``step`` (one decode step: every shape's times x its launches a
    forward) and ``prefill`` (the run's admissions) totals."""
    from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as dm
    from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as fm

    act = device_qscalars(dev, 4.0, 4, 4, 1)
    rows = {}
    for t in run["chunks"]:
        rows[t] = rows.get(t, 0) + 1
    out = {key: {"step": {}, "prefill": {}} for key in ("K2", "K4")}
    for name, k, n, per_forward in llama_dense_shapes(spec):
        x, wq, bias = gemm_operands(max(max(rows), LLAMA_SLOTS), k, n, dev, seed=k + n)
        w16 = wq.to(torch.bfloat16)
        pw = dm.pack_weights(wq, bias, 3, 4)
        del wq
        w_eff = dm.unpack_weights(pw)
        wd16 = w_eff.to(torch.bfloat16)
        for m in [LLAMA_SLOTS] + sorted(rows):
            xm = x[:m].contiguous()
            xq = fm.quantize_block_plain(xm, *act)
            x16 = xq.to(torch.bfloat16)
            calls = {
                "K2": (lambda: fm.fused_quant_matmul(xm, w16, act, quantize_x=True),
                       lambda: fm.fused_quant_matmul_plain(xm, w16, act, quantize_x=True),
                       lambda: torch.matmul(x16, w16), w16.float(),
                       4 * m * k + 2 * k * n + 4 * m * n),
                "K4": (lambda: dm.dequant_matmul(x16, pw.codes, pw.bias, expo_width=3,
                                                 mant_width=4),
                       lambda: dm.dequant_matmul_plain(x16, pw.codes, pw.bias, expo_width=3,
                                                       mant_width=4),
                       lambda: torch.matmul(x16, wd16), w_eff,
                       2 * m * k + k * n + 4 * n + 4 * m * n),
            }
            line = []
            for key, (kernel, plain, lib, w_check, nbytes) in calls.items():
                ours, ref = kernel(), plain()
                route, ok, frac = gemm_verdict(fm, ours, ref, xq, w_check, None, ref)
                worst[key] = max(worst[key], float((ours - ref).abs().nan_to_num(0.0).max()))
                if not ok:
                    raise SystemExit(f"{key} route {route} breaks its contract at the Llama "
                                     f"shape {name} M={m}")
                del ours, ref
                ms = cuda_ms(kernel, 5, SHORT_HEAD_START)
                lib_ms = cuda_ms(lib, 5, SHORT_HEAD_START)
                bytes_ms, ops_ms = _bound(nbytes, 2 * m * k * n)
                t = dict(ms=ms, library_ms=lib_ms, bytes_ms=bytes_ms, ops_ms=ops_ms)
                if m == LLAMA_SLOTS:
                    _add(out[key]["step"], per_forward, **t)
                if m in rows:
                    _add(out[key]["prefill"], per_forward * rows[m], **t)
                line.append(f"{key} {ms:.4f} ms x{per_forward} ({2 * m * k * n / ms / 1e9:.4g} "
                            f"TFLOP/s; bound {max(bytes_ms, ops_ms):.4f} ms, torch.matmul "
                            f"{lib_ms:.4f} ms)")
            phase("kernels", f"Llama {name} M={m}x{k}x{n}, route {fm.gemm_route(m)}, within "
                             f"its contract with plain: " + "; ".join(line))
            del xm, xq, x16, calls
        del x, w16, pw, w_eff, wd16
        torch.cuda.empty_cache()
    launches = llama_dense_per_forward(spec)
    for key in out:
        step, pre = _finish(out[key]["step"]), _finish(out[key]["prefill"])
        step["launches"] = launches
        phase("kernels", f"{key} per decode step (M={LLAMA_SLOTS}, {launches} launches): kernel "
                         f"{step['ms']:.3f} ms, bound {step['bound_ms']:.3f} ms "
                         f"({step['bound_by']}), torch.matmul {step['library_ms']:.3f} ms; over "
                         f"the run's admissions (M in {sorted(rows)}): kernel {pre['ms']:.3f} ms, "
                         f"bound {pre['bound_ms']:.3f} ms, torch.matmul "
                         f"{pre['library_ms']:.3f} ms")
    return out


def depth2_prefill(model, spec, qp, dev, decode_step=False):
    """Phase 5: the prefill logits (f32) of the second prompt as one
    right-padded chunk into an empty cache of the model's layout, then with
    ``decode_step`` the logits of one more token after it."""
    from fp8_quantization_tpu_torch.models.llama import KVCache
    from fp8_quantization_tpu_torch.models.serving import _pad_to_bucket

    prompt = llama_prompts(spec)[1]
    real = len(prompt)
    tokens = torch.zeros((1, _pad_to_bucket(real)), dtype=torch.long, device=dev)
    tokens[0, :real] = torch.tensor(prompt, device=dev)
    kv = torch.uint8 if model.packed_kv else torch.bfloat16
    cache = KVCache.zeros(spec, 1, LLAMA_MAX_SEQ, dtype=kv, device=dev)
    with torch.no_grad():
        logits, cache = model(tokens, cache, qp, chunk_attention=True)
        out = [logits[0, :real].float()]
        if decode_step:
            nxt = logits[:, real - 1].argmax(-1, keepdim=True)
            out.append(model(nxt, cache, qp)[0][0].float())
    return out


def top2_margin(row):
    """The top-1 minus the top-2 logit of a (V,) row."""
    top = torch.topk(row, 2).values
    return float(top[0] - top[1])


def depth2_generate(model, spec, qp, margins=None, calls=None, plain_admissions=False):
    """Phase 5: the greedy tokens of the first two prompts, 8 each, through
    a two-slot batcher. With ``plain_admissions`` the admissions (prefill)
    run through the plain versions and the decode steps through the
    kernels. With ``calls`` (a list), it receives the f32 logits of every
    call (an admission's (1, T, V), a step's (slots, 1, V)); with
    ``margins`` (a list), for each prompt the top-1/top-2 logit margin
    behind each of its tokens."""
    from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher

    batcher = ContinuousBatcher(model, spec, slots=2, max_seq=LLAMA_MAX_SEQ, qp=qp)
    seen = []

    def call(tokens, *args, **kwargs):
        admission = tokens.shape[1] > 1
        with plain_kernels() if plain_admissions and admission else contextlib.nullcontext():
            logits, cache = model(tokens, *args, **kwargs)
        seen.append(logits.float())
        return logits, cache

    batcher.model = call
    prompts = llama_prompts(spec)[:2]
    slots = [batcher.admit(p, max_new_tokens=8) for p in prompts]
    batcher.run_to_completion()
    tokens = [batcher.retire(s) for s in slots]
    if calls is not None:
        calls.extend(seen)
    if margins is not None:
        admits, steps = seen[:2], seen[2:]
        for p, slot, logits, toks in zip(prompts, slots, admits, tokens):
            rows = [logits[0, len(p) - 1]] + [step[slot, -1] for step in steps]
            margins.append([top2_margin(r) for r in rows[:len(toks)]])
    return tokens


def tokens_agree_while_decided(toks, plain_toks, plain_margins, max_diff):
    """The Llama token rule for a kernel run whose prefill went through
    K2/K4 route B. Walking each prompt's greedy tokens, a token whose plain
    top-1/top-2 margin is at least twice ``max_diff`` (the max |d| of the
    prefill logits) is decided and must be equal; an undecided one may
    differ, and the walk ends at the first that does (the contexts part
    there). Returns (ok, decided tokens compared per prompt): ok needs at
    least one compared."""
    ok, compared = True, []
    for ours, plain, margins in zip(toks, plain_toks, plain_margins):
        n = 0
        for o, p, mg in zip(ours, plain, margins):
            if mg >= 2 * max_diff:
                n += 1
                ok = ok and o == p
            if o != p:
                break
        compared.append(n)
        ok = ok and len(ours) == len(plain)
    return ok and sum(compared) > 0, compared


def check_llama_uniform(dev, counters):
    """Phase 5: full-width Llama-3-8B at depth 2 in the uniform
    configurations. w4a8 PACKED+fused on a bf16 cache, from one calibrated
    and packed state, three ways. (1) Exactly: with K7 through its plain
    version on both sides (its tensor cores sum in their own order), the
    prefill logits and greedy tokens through K5 and K6 equal those through
    their plain versions (max |d| 0: K5 is integer-exact and K6 sums in its
    plain version's order). (2) K7 held on its own inputs: the same prefill
    and tokens through every kernel, each K7 call within its contract
    (``verified_attention``). Then ``uniform_qc(8)`` under PACKED and
    CHAINED (``Coded`` int8 activations between layers): bit-equal prefill
    and decode-step logits."""
    from fp8_quantization_tpu_torch.models.llama import LLAMA3_8B
    from fp8_quantization_tpu_torch.models.serving import pack_llama
    from fp8_quantization_tpu_torch.ops.cuda import attention as k7
    from fp8_quantization_tpu_torch.quant.sites import QuantPhase

    spec = dataclasses.replace(LLAMA3_8B, num_layers=2)
    model = calibrated_llama(spec, dev, seed=1, qc=llama_w4a8_qc())
    pack_llama(model)
    qp = serving_phase(True)
    sdpa = k7.fused_sdpa
    zero_counts(counters)
    k7.fused_sdpa = k7.fused_sdpa_plain
    try:
        logits, toks = depth2_prefill(model, spec, qp, dev)[0], depth2_generate(model, spec, qp)
    finally:
        k7.fused_sdpa = sdpa
    counts = read_counts(counters)
    with plain_kernels():
        plain_logits, plain_toks = (depth2_prefill(model, spec, qp, dev)[0],
                                    depth2_generate(model, spec, qp))
    diff = float((logits - plain_logits).abs().max())
    zero_counts(counters)
    with verified_attention({}) as held:
        kernel_logits = depth2_prefill(model, spec, qp, dev)[0]
        kernel_toks = depth2_generate(model, spec, qp)
    kernel_counts = read_counts(counters)
    ok = (torch.equal(logits, plain_logits) and toks == plain_toks
          and bool(torch.isfinite(logits).all()) and logits.shape[1] == spec.vocab_size
          and min(counts["K5"], counts["K6"]) > 0 and counts["K7"] == 0
          and counts["K1"] == counts["K2"] == counts["K4"] == 0
          and held["K7"] == kernel_counts["K7"] > 0 and kernel_counts["K1"] == 0
          and bool(torch.isfinite(kernel_logits).all())
          and read_counts(counters) == kernel_counts and not model.packed_kv)
    kernel_diff = float((kernel_logits - plain_logits).abs().max())
    phase("model", f"Llama-3-8B width {spec.hidden_size}, depth 2, w4a8 PACKED+fused, bf16 KV, "
                   f"K7 through its plain version on both sides: prefill logits "
                   f"({logits.shape[0]} tokens) max|kernel - plain| {diff:.3g}; greedy tokens "
                   f"{toks} {'equal' if toks == plain_toks else 'DIFFER: ' + str(plain_toks)}; "
                   f"launches {counts}. Through every kernel: {held['K7']} K7 calls within "
                   f"their contract (min equal fraction {held['min_equal']:.4f}, worst |d| / "
                   f"bound {held['worst_ratio']:.3g}), prefill logits max|d| {kernel_diff:.3g}, "
                   f"tokens {'equal' if kernel_toks == plain_toks else 'differ: ' + str(kernel_toks)}"
                   f"; launches {kernel_counts}; ok={ok}")
    if not ok:
        raise SystemExit("Llama depth 2 w4a8: kernels and plain versions disagree")
    del model
    torch.cuda.empty_cache()

    model = calibrated_llama(spec, dev, seed=1, qc=llama_int8_qc())
    pack_llama(model)
    chained = QuantPhase(phase="fixed", fast=True, packed=True, chained=True, fused_sdpa=True)
    zero_counts(counters)
    packed_out = depth2_prefill(model, spec, serving_phase(True), dev, decode_step=True)
    chained_out = depth2_prefill(model, spec, chained, dev, decode_step=True)
    counts = read_counts(counters)
    ok = (all(torch.equal(a, b) for a, b in zip(packed_out, chained_out))
          and all(bool(torch.isfinite(a).all()) for a in packed_out)
          and counts["K7"] > 0 and counts["K6"] > 0 and counts["K5"] == 0)
    phase("model", f"Llama-3-8B width {spec.hidden_size}, depth 2, uniform_qc(8): PACKED and "
                   f"CHAINED prefill and decode-step logits bit-equal {ok} (max|d| "
                   f"{max(float((a - b).abs().max()) for a, b in zip(packed_out, chained_out)):.3g}"
                   f"); launches {counts}")
    if not ok:
        raise SystemExit("Llama depth 2 int8: CHAINED differs from PACKED")
    del model
    torch.cuda.empty_cache()


def check_llama_model(dev, counters):
    """Phase 5: full-width Llama-3-8B at depth 2 through the kernels and
    through their plain versions, from one calibrated state, under FAST+fused
    and then (packed and stripped in place) PACKED+packed_kv+fused. The
    prefill runs K2/K4 route B, whose tensor cores sum in their own order;
    decode (M <= 2) is route A and exact. Every K2/K4 and K7 call of the
    kernel run is held to its contract with the plain version on its own
    inputs (``verified_gemms``, ``verified_attention``), and every K1 call to
    equality; the prefill logits to ``RMS_LIMIT`` and to
    the same argmax wherever the plain top-1/top-2 margin is at least twice
    their max |d|; the greedy tokens of two prompts through the batcher to
    ``tokens_agree_while_decided``. Decode is then held exactly: with the
    admissions through the plain versions and the steps through the
    kernels, every logit and token equals the plain run's."""
    from fp8_quantization_tpu_torch.models.llama import LLAMA3_8B
    from fp8_quantization_tpu_torch.models.serving import pack_llama

    spec = dataclasses.replace(LLAMA3_8B, num_layers=2)
    model = calibrated_llama(spec, dev, seed=1)
    for name, packed in (("FAST+fused", False), ("PACKED+packed_kv+fused", True)):
        if packed:
            pack_llama(model)
        qp = serving_phase(packed)

        def prefill():
            return depth2_prefill(model, spec, qp, dev)[0]

        zero_counts(counters)
        with verified_gemms({}) as calls, verified_attention({}) as held:
            logits = prefill()
            toks = depth2_generate(model, spec, qp)
        counts = read_counts(counters)
        plain_margins, plain_calls = [], []
        with plain_kernels():
            plain_logits = prefill()
            plain_toks = depth2_generate(model, spec, qp, plain_margins, plain_calls)
        dense = "K4" if packed else "K2"
        if (min(counts["K7"], counts["K6"], counts[dense], counts["K1"]) == 0
                or read_counts(counters) != counts):
            raise SystemExit(f"Llama depth 2 {name}: launches {counts} (K7, K6, {dense} and "
                             "K1 expected; none from the plain versions)")
        diff = float((logits - plain_logits).abs().max())
        rms_ok, rms_line = rms_verdict(rel_rms(logits, plain_logits), prefill, plain_logits)
        top2 = torch.topk(plain_logits, 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) >= 2 * diff
        same = bool(((logits.argmax(-1) == plain_logits.argmax(-1)) | ~decided).all())
        agree, compared = tokens_agree_while_decided(toks, plain_toks, plain_margins, diff)
        zero_counts(counters)
        mixed_calls = []
        mixed_toks = depth2_generate(model, spec, qp, calls=mixed_calls, plain_admissions=True)
        mixed = read_counts(counters)
        exact = (mixed_toks == plain_toks and len(mixed_calls) == len(plain_calls)
                 and all(torch.equal(a, b) for a, b in zip(mixed_calls, plain_calls))
                 and mixed["K7"] == 0 and min(mixed["K6"], mixed[dense], mixed["K1"]) > 0)
        ok = (bool(torch.isfinite(logits).all()) and rms_ok and same and agree and exact
              and logits.shape[1] == spec.vocab_size and calls["calls"] == counts[dense]
              and held["K7"] == counts["K7"] and held["K1"] == counts["K1"])
        phase("model", f"Llama-3-8B width {spec.hidden_size}, depth 2, {name}: prefill logits "
                       f"({logits.shape[0]} tokens) max|kernel - plain| {diff:.3g}, {rms_line}, "
                       f"same argmax where decided {same} ({int(decided.sum())} of "
                       f"{decided.numel()} positions decided); {calls['calls']} {dense} calls "
                       f"(routes {sorted(calls['routes'])}) and {held['K7']} K7 calls (min equal "
                       f"fraction {held['min_equal']:.4f}, worst |d| / bound "
                       f"{held['worst_ratio']:.3g}) within their contract, {held['K1']} K1 "
                       f"calls equal to plain; greedy tokens {toks} "
                       f"{'equal' if toks == plain_toks else 'differ: plain ' + str(plain_toks)}; "
                       f"the token rule compared {compared} decided tokens (plain top-1/top-2 "
                       f"margin at least 2 x {diff:.3g}; margins "
                       f"{[[round(m, 4) for m in ms] for ms in plain_margins]}), agree {agree}; "
                       f"plain admissions and kernel decode steps: logits and tokens equal to "
                       f"the plain run {exact} (launches {mixed}); launches {counts}; ok={ok}")
        if not ok:
            raise SystemExit(f"Llama depth 2 {name}: kernels and plain versions disagree")


def check_vit_fused(cli, dev, spec, counters):
    """Phase 5: the published-flag ViT under FAST with ``fused_sdpa=True``
    through the kernels (K1, K2, K7) and their plain versions. At batch 1
    (M = 197) K2 takes route B, and K7 runs on the tensor cores, whose sums
    may put a requant output one grid step from the plain one at a rounding
    midpoint, and such a step carries through the later sites: every K2 and
    K7 call of the kernel forward is held to its contract with the plain
    version on its own inputs (``verified_gemms``, ``verified_attention``),
    every K1 call to equality, and the logits to ``RMS_LIMIT`` and the same
    top-1."""
    from fp8_quantization_tpu_torch.quant.sites import QuantPhase

    model, _, xt = calibrated_model(cli, PUBLISHED_FLAGS, dev, spec)
    qp = QuantPhase(phase="fixed", fast=True, fused_sdpa=True)

    def forward():
        with torch.no_grad():
            return model(xt, qp).float()

    zero_counts(counters)
    with verified_gemms({}) as calls, verified_attention({}) as held:
        logits = forward()
    counts = read_counts(counters)
    with plain_kernels():
        plain = forward()
    diff = float((logits - plain).abs().max())
    rms_ok, rms_line = rms_verdict(rel_rms(logits, plain), forward, plain)
    same = bool((logits.argmax(-1) == plain.argmax(-1)).all())
    ok = (counts["K7"] == spec.num_layers and counts["K2"] == 6 * spec.num_layers + 1
          and counts["K1"] > 0 and read_counts(counters) == counts and same and rms_ok
          and calls["calls"] == counts["K2"] and bool(torch.isfinite(logits).all())
          and held["K7"] == counts["K7"] and held["K1"] == counts["K1"])
    phase("model", f"ViT-B/16 FAST+fused, depth {spec.num_layers}, batch 1: {calls['calls']} K2 "
                   f"calls (routes {sorted(calls['routes'])}) each within its contract with plain "
                   f"on its own inputs (min equal fraction {calls['min_equal']:.4f}), {held['K7']} "
                   f"K7 calls within theirs (min equal fraction {held['min_equal']:.4f}, worst "
                   f"|d| / bound {held['worst_ratio']:.3g}), {held['K1']} K1 calls equal; logits "
                   f"max|kernel - plain| {diff:.3g}, {rms_line}, same top-1 {same}, "
                   f"launches {counts}, ok={ok}")
    if not ok:
        raise SystemExit("ViT FAST+fused: kernels and plain versions disagree")


def run_llama_serving(dev, counters):
    """Phase 4 for Llama-3-8B: one model, calibrated once; the FAST run on a
    bf16 cache, then packing and stripping in place and the PACKED run on a
    uint8 cache of the same calibrated sites."""
    from fp8_quantization_tpu_torch.models.llama import LLAMA3_8B
    from fp8_quantization_tpu_torch.models.serving import pack_llama

    spec = LLAMA3_8B
    t0 = time.perf_counter()
    model = calibrated_llama(spec, dev, seed=0)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in model.parameters())
    phase("main", f"Llama-3-8B: {params / 1e9:.3f} B parameters, built and calibrated in "
                  f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.2f}"
                  f" GB allocated")
    k1 = llama_k1_per_forward(spec)
    dense = llama_dense_per_forward(spec)
    runs = {"fast": serve_llama("FAST+fused, bf16 KV", model, spec, serving_phase(False),
                                counters, dev, {"K1": k1, "K2": dense})}
    profile_decode("FAST+fused", model, spec, serving_phase(False), dev)
    t0 = time.perf_counter()
    report = pack_llama(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase("main", f"packed {len(report)} layers in {time.perf_counter() - t0:.1f} s (bit-exact "
                  f"channel fraction {min(report.values()):.3f}..{max(report.values()):.3f}), "
                  f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    runs["packed"] = serve_llama("PACKED+packed_kv+fused, uint8 KV", model, spec,
                                 serving_phase(True), counters, dev, {"K1": k1, "K4": dense})
    profile_decode("PACKED+packed_kv+fused", model, spec, serving_phase(True), dev)
    del model
    torch.cuda.empty_cache()
    return spec, runs


def run_llama_w4a8(dev, counters):
    """Phase 4 for Llama-3-8B in w4a8 (``scripts/bench_llama_big.py``'s
    ``int4_qc``), after the FP8 model is freed: built and calibrated anew,
    packed to nibble codes by ``pack_llama`` (the KV cache stays bf16), and
    served as the FP8 runs are, every projection and ``lm_head`` through
    K5."""
    from fp8_quantization_tpu_torch.models.llama import LLAMA3_8B
    from fp8_quantization_tpu_torch.models.serving import pack_llama

    spec = LLAMA3_8B
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    model = calibrated_llama(spec, dev, seed=0, qc=llama_w4a8_qc())
    torch.cuda.synchronize()
    calib_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    phase("main", f"Llama-3-8B w4a8: built and calibrated in {time.perf_counter() - t0:.1f} s, "
                  f"peak {calib_gb:.2f} GB (f32 weight caches of the uniform grids)")
    t0 = time.perf_counter()
    report = pack_llama(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase("main", f"packed {len(report)} layers to nibbles in {time.perf_counter() - t0:.1f} s "
                  f"(bit-exact channel fraction {min(report.values()):.3f}.."
                  f"{max(report.values()):.3f}), packed_kv {model.packed_kv}, "
                  f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    if model.packed_kv or min(report.values()) != 1.0:
        raise SystemExit("w4a8 packing: a channel is not bit-exact or the cache is not bf16")
    qp = serving_phase(True)
    run = serve_llama("w4a8 PACKED+fused, bf16 KV", model, spec, qp, counters, dev,
                      {"K5": llama_dense_per_forward(spec)})
    run["calib_peak_gb"] = calib_gb
    profile_decode("w4a8 PACKED+fused", model, spec, qp, dev)
    del model
    torch.cuda.empty_cache()
    return run


# ---------------------------------------------------------------------------
# The CNN slice: MobileNetV2 (1.0, 224) and ResNet-18/50 under
# validate-quantized at full width, batch 16 (scripts/image_net.sh's default)
CNN_BATCH = 16
CNN_SIZE = 224
# the (t, c, n, s) table of MobileNetV2 (fp8_quantization_tpu_torch/models/
# mobilenet_v2.py) and ResNet's (kind, blocks per stage)
MOBILENET_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                     (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
RESNET_BLOCKS = {18: ("basic", (2, 2, 2, 2)), 50: ("bottleneck", (3, 4, 6, 3))}
# validate-quantized's forwards in a run: the init forward of a zeros image,
# one calibration batch and two eval batches
CNN_EVALS = 2


def _conv_out(hw, k, stride, pad):
    return (hw + 2 * pad - k) // stride + 1


def cnn_products(arch, batch, size=CNN_SIZE):
    """Every product of one forward, read off the architecture's table:
    ``(name, groups, M, K, N)`` with M the im2col rows at ``batch``. The
    ungrouped ones (groups 1) and the classifier are K3's under the approx
    run method; the grouped ones go to the oracle, one call each."""
    out = []
    if arch == "mobilenet_v2_quantized":
        hw, in_ch = _conv_out(size, 3, 2, 1), 32
        out.append(("stem 3x3", 1, batch * hw * hw, 27, 32))
        for t, c, n, s in MOBILENET_SETTING:
            for i in range(n):
                stride, hidden = (s if i == 0 else 1), in_ch * t
                if t != 1:
                    out.append(("expand 1x1", 1, batch * hw * hw, in_ch, hidden))
                hw = _conv_out(hw, 3, stride, 1)
                out.append(("depthwise 3x3", hidden, batch * hw * hw, 9, 1))
                out.append(("project 1x1", 1, batch * hw * hw, hidden, c))
                in_ch = c
        out.append(("last 1x1", 1, batch * hw * hw, in_ch, 1280))
        out.append(("classifier", 1, batch, 1280, 1000))
        return out
    kind, reps = RESNET_BLOCKS[int(arch[6:8])]
    expansion = 1 if kind == "basic" else 4
    hw = _conv_out(size, 7, 2, 3)
    out.append(("stem 7x7", 1, batch * hw * hw, 147, 64))
    hw, in_ch = _conv_out(hw, 3, 2, 1), 64
    for li, (width, n) in enumerate(zip((64, 128, 256, 512), reps)):
        for bi in range(n):
            stride = (1 if li == 0 else 2) if bi == 0 else 1
            out_ch, hw_out = width * expansion, _conv_out(hw, 3, stride, 1)
            if stride != 1 or in_ch != out_ch:
                out.append(("downsample 1x1", 1, batch * hw_out * hw_out, in_ch, out_ch))
            if kind == "basic":
                out.append(("3x3", 1, batch * hw_out * hw_out, 9 * in_ch, width))
                out.append(("3x3", 1, batch * hw_out * hw_out, 9 * width, width))
            else:
                out.append(("1x1", 1, batch * hw * hw, in_ch, width))
                out.append(("3x3", 1, batch * hw_out * hw_out, 9 * width, width))
                out.append(("1x1", 1, batch * hw_out * hw_out, width, out_ch))
            hw, in_ch = hw_out, out_ch
    out.append(("fc", 1, batch, in_ch, 1000))
    return out


def cnn_per_forward(arch):
    """Launches and oracle calls of one forward. K3 (approx) and the oracle:
    one per ungrouped and grouped product. K1 (``--fast-mode``): one per
    per-tensor act or res site, that is, two per conv and for the
    classifier (its input and its result), one per residual site (a block
    that keeps its shape; ResNet's last block hands its site to the pool)
    and one for the pool's output (ResNet's second, tied call is
    ``FIXED``). ``K1 fused`` (``--chained-acts`` on FP8): the same less
    the act sites a pending ``Affine`` feeds, which fold it in plain
    PyTorch: every conv of a block after its first (ResNet) and, in
    MobileNetV2, also a block's first conv (and the last 1x1) where the
    block before it ends without a residual site. K2 / K4 / K5: the
    classifier. ``int8_conv``: every conv (``fastpath.quantized_conv_int8``
    under uniform ``--packed-weights``)."""
    if arch == "vit_quantized":
        return {"K3": 0, "oracle": 0, "K1": 0, "K1 fused": 0, "dense": 0, "int8_conv": 1}
    products = cnn_products(arch, 1)
    convs = sum(1 for p in products if p[0] not in ("classifier", "fc"))
    if arch == "mobilenet_v2_quantized":
        in_ch, residual, affine_fed, plain = 32, 0, 0, False    # the stem leaves an Affine
        for t, c, n, s in MOBILENET_SETTING:
            for i in range(n):
                res = (s if i == 0 else 1) == 1 and (in_ch if i == 0 else c) == c
                affine_fed += (0 if plain else 1) + (1 if t == 1 else 2)
                residual, plain = residual + res, res
            in_ch = c
        affine_fed += 0 if plain else 1                           # the last 1x1
    else:
        kind, reps = RESNET_BLOCKS[int(arch[6:8])]
        residual = sum(reps) - 1
        affine_fed = sum(reps) * (1 if kind == "basic" else 2)
    k1 = 2 * convs + 2 + residual + 1
    return {"K3": sum(1 for p in products if p[1] == 1),
            "oracle": sum(1 for p in products if p[1] > 1),
            "K1": k1, "K1 fused": k1 - affine_fed, "dense": 1, "int8_conv": convs}


def cnn_expected(arch, mode):
    """Each kernel's launches (and the oracle's and the int8 conv's calls)
    in one validate-quantized run: approx runs K3 and the oracle in all four
    forwards; ``--fast-mode`` K1 and K2 in the two eval forwards;
    ``--packed-weights`` also in the weight-cache forward (a fast one), and
    K4 in the eval forwards; ``fp8 chained`` as packed with the fused
    boundary's K1 in the eval forwards; the uniform serving runs (``int8``,
    ``w4a8``) the int8 conv in the eval forwards and, at 4 bits, K5 for the
    classifier; the published flags launch nothing."""
    per = cnn_per_forward(arch)
    want = {name: 0 for name in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "oracle",
                                 "int8_conv")}
    if mode == "approx":
        want["K3"], want["oracle"] = per["K3"] * (2 + CNN_EVALS), per["oracle"] * (2 + CNN_EVALS)
    elif mode == "fast":
        want["K1"], want["K2"] = per["K1"] * CNN_EVALS, per["dense"] * CNN_EVALS
    elif mode in ("packed", "fp8 chained"):
        fused = per["K1 fused"] if mode == "fp8 chained" else per["K1"]
        want["K1"], want["K2"] = per["K1"] + fused * CNN_EVALS, per["dense"]
        want["K4"] = per["dense"] * CNN_EVALS
    elif mode != "published":
        want["int8_conv"] = per["int8_conv"] * CNN_EVALS
        if mode.startswith("w4a8"):
            want["K5"] = per["dense"] * CNN_EVALS
    return want


# scripts/bench_cnn.py's int8 configuration (its qci; no res sites)
INT8_FLAGS = ["--qmethod", "symmetric_uniform", "--per-channel", "--weight-quant-method",
              "current_minmax", "--act-quant-method", "allminmax", "--quantize-input"]


def cnn_flags(arch, mode):
    """``PUBLISHED_FLAGS`` on a CNN (or the ViT) at batch 16, in one of the
    ways: published, approx, fast, packed, ``fp8 chained`` (the FP8 fused
    boundary), and the uniform serving runs on ``INT8_FLAGS``: ``int8
    packed``, ``int8 chained`` and ``w4a8 chained`` (4-bit weights, 8-bit
    acts, as ``scripts/bench_cnn.py``'s ``chained4``)."""
    flags = list(PUBLISHED_FLAGS)
    flags[flags.index("--architecture") + 1] = arch + ("_approx" if mode == "approx" else "")
    flags[flags.index("--batch-size") + 1] = str(CNN_BATCH)
    if mode.startswith(("int8", "w4a8")):
        flags = flags[:flags.index("--n-bits")] + INT8_FLAGS + [
            "--approx-output-dir", "approx_output", "--max-eval-batches", "2",
            "--packed-weights"] + (["--n-bits", "4", "--n-bits-act", "8"]
                                   if mode.startswith("w4a8") else [])
        return flags + (["--chained-acts"] if mode.endswith("chained") else [])
    if mode == "approx":
        flags[flags.index("--no-approx_flag")] = "--approx_flag"
        flags += ["--withComp", "--with_approx"]
    return flags + {"published": [], "approx": [], "fast": ["--fast-mode"],
                    "packed": ["--fast-mode", "--packed-weights"],
                    "fp8 chained": ["--fast-mode", "--packed-weights", "--chained-acts"]}[mode]


CNN_RUNS = ([("mobilenet_v2_quantized", m) for m in ("published", "approx", "fast", "packed")]
            + [("resnet18_quantized", "published"), ("resnet18_quantized", "approx"),
               ("resnet50_quantized", "published"), ("resnet50_quantized", "fast")]
            # the serving boundary: A (FP8 fused), B (int8), C (w4a8), D (ViT int8)
            + [(a, "fp8 chained") for a in ("mobilenet_v2_quantized", "resnet18_quantized",
                                            "resnet50_quantized")]
            + [(a, m) for a in ("mobilenet_v2_quantized", "resnet18_quantized")
               for m in ("int8 packed", "int8 chained")]
            + [("resnet50_quantized", "int8 chained"), ("mobilenet_v2_quantized", "w4a8 chained"),
               ("vit_quantized", "int8 packed"), ("vit_quantized", "int8 chained")])


@contextlib.contextmanager
def counted_calls(record):
    """Counts the calls of the grouped convs' oracle
    (``layers.approx_matmul_oracle``) and of the int8 conv
    (``fastpath.quantized_conv_int8``) in ``record["oracle"]`` and
    ``record["int8_conv"]``; neither is a hand kernel with a counter of its
    own."""
    from fp8_quantization_tpu_torch.ops import fastpath, layers

    swaps = [(layers, "approx_matmul_oracle", "oracle"),
             (fastpath, "quantized_conv_int8", "int8_conv")]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for (mod, name, key), fn in zip(swaps, saved):
        record[key] = 0

        def call(*args, _fn=fn, _key=key, **kw):
            record[_key] += 1
            return _fn(*args, **kw)

        setattr(mod, name, call)
    try:
        yield record
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def card_power():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def run_cnn(cli, counters, arch, mode):
    """One CNN ``validate-quantized`` run with every count zeroed just
    before it, held to :func:`cnn_expected`. Returns (out, ms/img, counts)."""
    zero_counts(counters)
    with counted_calls({}) as calls:
        out, ms = run_cli(cli, cnn_flags(arch, mode))
    counts = {**read_counts(counters), **calls}
    want = cnn_expected(arch, mode)
    phase("main", f"{arch} {mode}: {out['metrics']}, {ms:.2f} ms/img over {out['images']} "
                  f"images ({card_power()}), launches {counts} (expected {want}), result "
                  f"{out['result_file']}")
    if counts != want or not np.isfinite(out["metrics"]["loss"]):
        raise SystemExit(f"{arch} {mode} validate-quantized: wrong launch counts or bad metrics")
    return out, ms, counts


def check_k3_cnn(k3, dev, sm_clock_hz):
    """Phase 3, CNN shapes: K3 against its plain version at every distinct
    (K, N) of MobileNetV2's and ResNet-18's ungrouped products on a
    ``SLICE_ROWS`` row slice, bit for bit (which K3's contract, the sums
    within ``K * 2^-24 * sum_k |term_k|``, allows): under the flagship flags
    every product is requantized onto the result grid, a multiple of
    2^(1 - bias_r - M) = 2^-8, and the sums of up to 4608 such products stay
    below 2^24 of those steps, so they are exact in any order. Then K3 timed
    at every product of a batch-16 forward beside its bound (the largest of
    the bytes over HBM bandwidth, one table read a product and one f32 add a
    product). Returns (worst |d|, {arch: per-forward times})."""
    worst, times = 0.0, {}
    shapes = {(k, n) for arch in ("mobilenet_v2_quantized", "resnet18_quantized")
              for _, g, _, k, n in cnn_products(arch, 1) if g == 1}
    for k, n in sorted(shapes):
        a, b, bb = grid_operands(SLICE_ROWS, k, n, dev, seed=k + n, on_device=True)
        ours = k3.approx_matmul(a, b, 5, bb, 5, **FLAGSHIP)
        plain = k3.approx_matmul_plain(a, b, 5, bb, 5, **FLAGSHIP)
        worst = max(worst, float((ours - plain).abs().max()))
        if not (torch.equal(ours, plain) and bool(torch.isfinite(ours).all())):
            raise SystemExit(f"K3 disagrees with its plain version at the CNN shape {k}x{n}")
    phase("kernels", f"K3 at the {len(shapes)} distinct (K, N) of MobileNetV2 and ResNet-18 "
                     f"(K {min(k for k, _ in shapes)}..{max(k for k, _ in shapes)}, N "
                     f"{min(n for _, n in shapes)}..{max(n for _, n in shapes)}), "
                     f"{SLICE_ROWS}-row slices: equal to the plain version, max|d| {worst:.3g}")
    table_reads_per_s = (torch.cuda.get_device_properties(dev).multi_processor_count
                         * SHARED_WORDS_PER_SM_CLOCK * sm_clock_hz)
    for arch in ("mobilenet_v2_quantized", "resnet18_quantized"):
        per_shape = {}
        for name, g, m, k, n in cnn_products(arch, CNN_BATCH):
            if g == 1:
                per_shape.setdefault((m, k, n), [name, 0])[1] += 1
        totals = {"ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "adds_ms": 0.0, "launches": 0}
        lines = []
        for (m, k, n), (name, count) in sorted(per_shape.items(), key=lambda e: -e[0][0]):
            a, b, bb = grid_operands(m, k, n, dev, seed=m + k + n, on_device=True)
            ms = cuda_ms(lambda: k3.approx_matmul(a, b, 5, bb, 5, **FLAGSHIP), 3)
            bytes_ms = 1e3 * 4 * (m * k + k * n + m * n + n + 2) / HBM_BYTES_PER_S
            ops_ms = 1e3 * m * k * n / table_reads_per_s
            adds_ms = 1e3 * m * k * n / F32_ADDS_PER_S
            _add(totals, count, ms=ms, bytes_ms=bytes_ms, ops_ms=ops_ms, adds_ms=adds_ms)
            totals["launches"] += count
            lines.append(f"{name} {m}x{k}x{n} x{count} {ms:.4f} ms (bound "
                         f"{max(bytes_ms, ops_ms, adds_ms):.4f})")
            del a, b
        totals["bound_ms"] = max(totals["bytes_ms"], totals["ops_ms"], totals["adds_ms"])
        totals["bound_by"] = ("bytes" if totals["bytes_ms"] == totals["bound_ms"]
                              else "operations")
        times[arch] = totals
        phase("kernels", f"K3 {arch} per batch-{CNN_BATCH} forward: {totals['launches']} "
                         f"launches, {totals['ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms "
                         f"({totals['bound_by']}; table reads {totals['ops_ms']:.3f}, f32 adds "
                         f"{totals['adds_ms']:.3f}); by shape: " + "; ".join(lines))
        torch.cuda.empty_cache()
    return worst, times


def calibrated_cnn(cli, arch, mode, dev):
    """A full-width CNN built as the CLI builds it (seed 0) and calibrated
    on one synthetic image; returns (model, input image on the card)."""
    from fp8_quantization_tpu_torch.eval.data import synthetic_batches
    from fp8_quantization_tpu_torch.eval.driver import calibrate

    qc = cli.config_from_args(cli.build_parser().parse_args(cnn_flags(arch, mode)))
    model, _ = cli.build_model(arch, qc, dev, torch.Generator().manual_seed(0))
    (x, _), = synthetic_batches(1, 1, image_size=model.spec.image_size,
                                num_classes=model.spec.num_classes, seed=3)
    calibrate(model, [x], num_est_batches=1)
    return model, torch.from_numpy(x).to(dev)


def check_cnn_models(cli, dev, counters):
    """Phase 5 for MobileNetV2 at full width, batch 1, from one calibrated
    state each. Approx: FIXED logits through K3 and through its plain
    version (the grouped convs take the oracle on both sides). Every
    approximate product is requantized onto the result grid, so each is a
    multiple of 2^(1 - bias_r - M) and the sums over K (at most 1280 here)
    are exact in any order: the logits must be equal. FAST: every K2 call
    held to its contract and every K1 call to equality on its own inputs
    (``verified_gemms``, ``verified_attention``); at batch 1 the
    classifier's K2 takes route A, which sums as its plain version does, and
    the convs run ``F.conv2d`` on both sides, so these logits must be equal
    too. The relative RMS is printed beside the readings."""
    from fp8_quantization_tpu_torch.quant.sites import FAST, FIXED

    arch = "mobilenet_v2_quantized"
    per = cnn_per_forward(arch)
    model, xt = calibrated_cnn(cli, arch, "approx", dev)
    with torch.no_grad():
        zero_counts(counters)
        logits = model(xt, FIXED)
        counts = read_counts(counters)
        with plain_kernels():
            plain = model(xt, FIXED)
    diff, scale = float((logits - plain).abs().max()), float(plain.abs().max())
    rms = rel_rms(logits, plain)
    same = bool((logits.argmax(-1) == plain.argmax(-1)).all())
    ok = (tuple(logits.shape) == (1, model.spec.num_classes) and bool(torch.isfinite(logits).all())
          and torch.equal(logits, plain) and counts["K3"] == per["K3"]
          and read_counts(counters) == counts)
    phase("model", f"MobileNetV2 approx FIXED, width 1.0, batch 1: max|kernel - plain| = "
                   f"{diff:.3g} (max|logit| {scale:.3g}; must be 0), relative RMS {rms:.4g}, "
                   f"same top-1 {same}, launches {counts} (K3 expected {per['K3']}), ok={ok}")
    if not ok:
        raise SystemExit("MobileNetV2 approx: kernels and plain versions disagree")
    del model

    model, xt = calibrated_cnn(cli, arch, "published", dev)
    zero_counts(counters)
    with torch.no_grad(), verified_gemms({}) as calls, verified_attention({}) as held:
        logits = model(xt, FAST).float()
    counts = read_counts(counters)
    with torch.no_grad(), plain_kernels():
        plain = model(xt, FAST).float()
    diff = float((logits - plain).abs().max())
    rms = rel_rms(logits, plain)
    same = bool((logits.argmax(-1) == plain.argmax(-1)).all())
    ok = (counts["K2"] == per["dense"] == calls["calls"] and calls["routes"] == {"A"}
          and counts["K1"] == per["K1"] == held["K1"] and read_counts(counters) == counts
          and torch.equal(logits, plain) and bool(torch.isfinite(logits).all()))
    phase("model", f"MobileNetV2 FAST, width 1.0, batch 1: {calls['calls']} K2 calls (routes "
                   f"{sorted(calls['routes'])}) within their contract, {held['K1']} K1 calls "
                   f"equal to plain; logits max|kernel - plain| {diff:.3g} (must be 0), "
                   f"relative RMS {rms:.4g}, same top-1 {same}, launches {counts}, ok={ok}")
    if not ok:
        raise SystemExit("MobileNetV2 FAST: kernels and plain versions disagree")


def cnn_convs(arch, size=CNN_SIZE):
    """Every conv of one forward, read off the architecture's table:
    ``(name, kernel, stride, pad, in_ch, out_ch, groups, input hw)``."""
    out = []
    if arch == "mobilenet_v2_quantized":
        out.append(("stem 3x3", 3, 2, 1, 3, 32, 1, size))
        hw, in_ch = _conv_out(size, 3, 2, 1), 32
        for t, c, n, s in MOBILENET_SETTING:
            for i in range(n):
                stride, hidden = (s if i == 0 else 1), in_ch * t
                if t != 1:
                    out.append(("expand 1x1", 1, 1, 0, in_ch, hidden, 1, hw))
                out.append(("depthwise 3x3", 3, stride, 1, hidden, hidden, hidden, hw))
                hw = _conv_out(hw, 3, stride, 1)
                out.append(("project 1x1", 1, 1, 0, hidden, c, 1, hw))
                in_ch = c
        out.append(("last 1x1", 1, 1, 0, in_ch, 1280, 1, hw))
        return out
    kind, reps = RESNET_BLOCKS[int(arch[6:8])]
    expansion = 1 if kind == "basic" else 4
    out.append(("stem 7x7", 7, 2, 3, 3, 64, 1, size))
    hw, in_ch = _conv_out(_conv_out(size, 7, 2, 3), 3, 2, 1), 64
    for li, (width, n) in enumerate(zip((64, 128, 256, 512), reps)):
        for bi in range(n):
            stride = (1 if li == 0 else 2) if bi == 0 else 1
            out_ch, hw_out = width * expansion, _conv_out(hw, 3, stride, 1)
            if stride != 1 or in_ch != out_ch:
                out.append(("downsample 1x1", 1, stride, 0, in_ch, out_ch, 1, hw))
            if kind == "basic":
                out.append(("3x3", 3, stride, 1, in_ch, width, 1, hw))
                out.append(("3x3", 3, 1, 1, width, width, 1, hw_out))
            else:
                out.append(("1x1", 1, 1, 0, in_ch, width, 1, hw))
                out.append(("3x3", 3, stride, 1, width, width, 1, hw))
                out.append(("1x1", 1, 1, 0, width, out_ch, 1, hw_out))
            hw, in_ch = hw_out, out_ch
    return out


# the int8 conv check's row slice: the input cropped to at most this many
# rows and columns, batch 2
CONV_SLICE = 15


def int8_conv_operands(gen, batch, hw, kernel, in_ch, out_ch, groups, dev):
    """Random int8 activation and kernel codes (the largest magnitudes
    included) on ``dev``."""
    x = torch.randint(-128, 128, (batch, hw, hw, in_ch), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (kernel, kernel, in_ch // groups, out_ch), generator=gen,
                      dtype=torch.int8)
    x[0, 0] = -128
    w[..., 0] = -127
    return x.to(dev), w.to(dev)


def check_int8_conv(dev):
    """Phase 3, the int8 conv of uniform conv serving: its exact int32 sums
    on the card (``fastpath.int8_conv_sums``: im2col and ``torch._int_mm``
    for the ungrouped convs, an int32 multiply-and-sum over the taps for the
    depthwise ones) equal, by ``torch.equal``, the CPU's int32 path on the
    same codes, at every distinct conv of MobileNetV2 and ResNet-18 on a
    ``CONV_SLICE`` row slice, each with the zero point's code ``cx`` 0 and
    -128 (the padding's fill) and with the zero-point window sums. Then the
    sums timed at every conv of a batch-16 forward beside cuDNN's f32
    convolution of the same codes (``F.conv2d``, TF32 off) and the bound
    (the int8 bytes over HBM bandwidth, or the MACs at the dense int8
    tensor-core rate). Returns {arch: per-forward times}."""
    import torch.nn.functional as F

    from fp8_quantization_tpu_torch.ops.fastpath import int8_conv_sums

    gen = torch.Generator().manual_seed(9)
    shapes = {c[1:] for arch in ("mobilenet_v2_quantized", "resnet18_quantized")
              for c in cnn_convs(arch)}
    names = {c[1:]: c[0] for arch in ("mobilenet_v2_quantized", "resnet18_quantized")
             for c in cnn_convs(arch)}
    checked = set()
    for k, stride, pad, cin, cout, g, hw in sorted(shapes):
        x, w = int8_conv_operands(gen, 2, min(hw, CONV_SLICE), k, cin, cout, g, dev)
        for cx in (0.0, -128.0):
            kw = dict(strides=(stride, stride), padding=[(pad, pad)] * 2, dilation=(1, 1),
                      groups=g, with_xsum=True)
            ours = int8_conv_sums(x, w, torch.tensor(cx, device=dev), **kw)
            cpu = int8_conv_sums(x.cpu(), w.cpu(), torch.tensor(cx), **kw)
            if not (torch.equal(ours[0].cpu(), cpu[0]) and torch.equal(ours[1].cpu(), cpu[1])):
                raise SystemExit(f"int8 conv sums on the card differ from the CPU's at "
                                 f"{names[(k, stride, pad, cin, cout, g, hw)]} {k}x{k}/{stride} "
                                 f"{cin}->{cout} g{g}, cx {cx}")
        checked.add(names[(k, stride, pad, cin, cout, g, hw)])
    phase("kernels", f"int8 conv sums at the {len(shapes)} distinct convs of MobileNetV2 and "
                     f"ResNet-18 ({', '.join(sorted(checked))}), batch 2, inputs cropped to "
                     f"{CONV_SLICE}x{CONV_SLICE}, cx 0 and -128: equal to the CPU int32 path")
    times = {}
    for arch in ("mobilenet_v2_quantized", "resnet18_quantized"):
        counts = {}
        for c in cnn_convs(arch):
            counts[c[1:]] = counts.get(c[1:], 0) + 1
        totals = {"ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "convs": 0}
        for (k, stride, pad, cin, cout, g, hw), count in counts.items():
            x, w = int8_conv_operands(gen, CNN_BATCH, hw, k, cin, cout, g, dev)
            cx = torch.tensor(-128.0, device=dev)
            kw = dict(strides=(stride, stride), padding=[(pad, pad)] * 2, dilation=(1, 1),
                      groups=g)
            xf = x.permute(0, 3, 1, 2).float().contiguous()
            wf = w.permute(3, 2, 0, 1).float().contiguous()
            ho = _conv_out(hw, k, stride, pad)
            totals["ms"] += count * cuda_ms(lambda: int8_conv_sums(x, w, cx, **kw), 3)
            totals["library_ms"] += count * cuda_ms(
                lambda: F.conv2d(xf, wf, stride=stride, padding=pad, groups=g), 3)
            totals["bytes_ms"] += count * 1e3 * (x.numel() + w.numel() + 4 * CNN_BATCH * ho * ho
                                                 * cout) / HBM_BYTES_PER_S
            totals["ops_ms"] += count * 1e3 * 2 * CNN_BATCH * ho * ho * cout * k * k * cin / g \
                / INT8_TC_OPS_PER_S
            totals["convs"] += count
            del x, w, xf, wf
        totals["bound_ms"] = max(totals["bytes_ms"], totals["ops_ms"])
        totals["bound_by"] = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations"
        times[arch] = totals
        phase("kernels", f"int8 conv sums per {arch} batch-{CNN_BATCH} forward: "
                         f"{totals['convs']} convs, {totals['ms']:.3f} ms, cuDNN f32 conv of the "
                         f"same codes {totals['library_ms']:.3f} ms, bound "
                         f"{totals['bound_ms']:.3f} ms ({totals['bound_by']})")
        torch.cuda.empty_cache()
    return times


def served_cnn(cli, arch, mode, dev, batch):
    """A full-width model built, calibrated on one synthetic batch of
    ``batch`` images, its weights cached and packed as ``validate-quantized``
    does in ``mode``; returns (model, images on the card)."""
    from fp8_quantization_tpu_torch.eval.data import synthetic_batches
    from fp8_quantization_tpu_torch.eval.driver import cache_quantized_weights, calibrate
    from fp8_quantization_tpu_torch.ops.fastpath import pack_dense_caches

    args = cli.build_parser().parse_args(cnn_flags(arch, mode))
    qc = cli.config_from_args(args)
    model, example = cli.build_model(arch, qc, dev, torch.Generator().manual_seed(0))
    (x, _), = synthetic_batches(batch, 1, image_size=model.spec.image_size,
                                num_classes=model.spec.num_classes, seed=5)
    calibrate(model, [x], num_est_batches=1)
    cache_quantized_weights(model, example, fast=args.fast_mode)
    pack_dense_caches(model, qc)
    return model, torch.from_numpy(x).to(dev)


# the fused boundary's bound on the int8 logits, against the unfused path's
# own one-ulp reading (check_cnn_serving)
BN_ULP_FACTOR = 4


def bn_ulp_reading(model, xt, qp):
    """The largest max|d| of ``model``'s logits under ``qp`` when every BN
    ``gamma`` moves one ulp up, or one ulp down, against the logits as they
    are: how far a one-ulp difference in the BN constants, of the kind
    XLA's CPU ``rsqrt`` already makes to the JAX package, moves them."""
    bns = [m for m in model.modules() if getattr(m, "bn_follows", False)]
    saved = [m.gamma.detach().clone() for m in bns]
    base = model(xt, qp).float()
    worst = 0.0
    for direction in (float("inf"), -float("inf")):
        for m in bns:
            m.gamma.copy_(torch.nextafter(m.gamma, torch.full_like(m.gamma, direction)))
        worst = max(worst, float((model(xt, qp).float() - base).abs().max()))
        for m, g in zip(bns, saved):
            m.gamma.copy_(g)
    return worst


def check_cnn_serving(cli, dev, counters):
    """Phase 5, the CNN serving boundary at full width, CHAINED (the fused
    ``Affine`` boundary) against PACKED. The fused boundary folds the dequant
    epilogue, BN and the clamp into the next site's rounding with their
    constants rounded once, which moves a code wherever a value sits within
    an ulp of a rounding midpoint; the JAX package bounds the result by
    ``rtol = atol = 5e-4`` (int8) and ``5e-3`` (FP8) at 32x32
    (``tests/test_conv_serving.py``), but at 224x224 its own CHAINED and
    PACKED ResNet-18 logits are 0.037 apart (max|logit| 6.8; PERF.md §6,
    PR 9). So the int8 models (batch 2) are held to the same top-1 and to
    ``BN_ULP_FACTOR`` times the unfused path's own one-ulp reading
    (:func:`bn_ulp_reading`, taken in this run), with the 5e-4 reading
    printed beside; the FP8 MobileNetV2 (batch 16) to 5e-3, top-1 agreement
    of at least 0.9 and every disagreeing row within 4 x max|d| of its
    top-2 margin, the JAX test's rule."""
    from fp8_quantization_tpu_torch.quant.sites import CHAINED, PACKED

    for arch, mode, batch in (("mobilenet_v2_quantized", "int8 chained", 2),
                              ("resnet18_quantized", "int8 chained", 2),
                              ("mobilenet_v2_quantized", "fp8 chained", CNN_BATCH)):
        model, xt = served_cnn(cli, arch, mode, dev, batch)
        zero_counts(counters)
        with torch.no_grad(), counted_calls({}) as calls:
            packed = model(xt, PACKED).float()
            chained = model(xt, CHAINED).float()
        counts = {**read_counts(counters), **calls}
        with torch.no_grad():
            control = bn_ulp_reading(model, xt, PACKED)
        diff = float((chained - packed).abs().max())
        tol = 5e-4 if mode.startswith("int8") else 5e-3
        close = bool(torch.all((chained - packed).abs() <= tol + tol * packed.abs()))
        same = chained.argmax(-1) == packed.argmax(-1)
        ties = True
        for i in torch.nonzero(~same).flatten().tolist():
            top2 = torch.sort(packed[i]).values[-2:]
            ties = ties and float(top2[1] - top2[0]) <= 4 * diff
        agree = float(same.float().mean())
        if mode.startswith("int8"):
            ok = bool(same.all()) and diff <= BN_ULP_FACTOR * control
        else:
            ok = close and agree >= 0.9 and ties
        ok = ok and bool(torch.isfinite(chained).all())
        phase("model", f"{arch} {mode}, width 1.0, batch {batch}: CHAINED against PACKED max|d| "
                       f"{diff:.3g} (max|logit| {float(packed.abs().max()):.3g}; within "
                       f"rtol=atol={tol:g}: {close}; PACKED with every BN gamma one ulp off "
                       f"{control:.3g}), top-1 agreement {agree:.3f}, calls {counts}, ok={ok}")
        if not ok:
            raise SystemExit(f"{arch} {mode}: CHAINED and PACKED disagree")
        del model
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from fp8_quantization_tpu_torch import cli
    from fp8_quantization_tpu_torch.models.llama import LLAMA3_8B
    from fp8_quantization_tpu_torch.models.vit import VIT_B_16
    from fp8_quantization_tpu_torch.ops.cuda import KERNELS
    from fp8_quantization_tpu_torch.ops.cuda import approx_matmul as k3
    from fp8_quantization_tpu_torch.ops.cuda import build, sass_mix
    from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as dm
    from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as fm

    # full-f32 products and convolutions (TF32 would leave the grid)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    print(card_power(), flush=True)
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
                   f"per product (staging included; a diagnostic, the bound counts one "
                   f"table read a product), by class {mix['per_product_by_class']}")
    tc_mix = sass_mix.tensor_core_mix({n: built[n]["path"]
                                       for n in sass_mix.TENSOR_CORE_KERNELS})
    for name, funcs in tc_mix.items():
        kernel = sass_mix.TENSOR_CORE_KERNELS[name]
        phase("build", f"{name} tensor-core instructions (HMMA/HGMMA) per kernel: "
                       + ", ".join(f"{fn.split(kernel)[0][-6:]}{kernel}"
                                   f"{fn.split(kernel)[1][:14]} {c}"
                                   for fn, c in funcs.items()))
    if not sass_mix.uses_tensor_cores(tc_mix, "mma_gemm"):
        raise SystemExit("route B of K2/K4 has no tensor-core instruction in its SASS")
    if not sass_mix.uses_tensor_cores(tc_mix, "sdpa_kernel"):
        raise SystemExit("K7 has no tensor-core instruction in its SASS")
    if not sass_mix.uses_tensor_cores(tc_mix, "int4_"):
        raise SystemExit("a route of K5 has no tensor-core instruction in its SASS")

    # 3. kernels against their plain versions
    sm_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    max_err, k3_times = check_kernel_against_plain(k3, dev, 1e6 * sm_clock_mhz)
    gemm_err = check_gemms(fm, dm, dev)
    gemm_err["K1"] = check_k1(fm, dev)
    attention_err, k7_vit = check_attention(LLAMA3_8B, dev)
    gemm_err.update(attention_err)
    check_k5(dm, dev)
    cnn_err, k3_cnn = check_k3_cnn(k3, dev, 1e6 * sm_clock_mhz)
    max_err = max(max_err, cnn_err)
    int8_conv = check_int8_conv(dev)

    # 4. the main path: each run with every launch count zeroed just before
    counters = KERNELS
    zero_counts(counters)
    out, approx_ms = run_cli(cli, APPROX_FLAGS)
    approx_counts = read_counts(counters)
    # the CLI's init forward (a zeros batch of one), one calibration batch
    # and two eval batches
    expected = LAUNCHES_PER_FORWARD * (1 + 1 + 2)
    phase("main", f"vit_quantized_approx: {out['metrics']}, {approx_ms:.2f} ms/img over "
                  f"{out['images']} images, launches {approx_counts} (K3 expected "
                  f"{expected}), result {out['result_file']}")
    if approx_counts["K3"] != expected or not np.isfinite(out["metrics"]["loss"]):
        raise SystemExit("approx validate-quantized: wrong launch count or bad metrics")
    zero_counts(counters)
    out_pub, pub_ms = run_cli(cli, PUBLISHED_FLAGS)
    pub_counts = read_counts(counters)
    phase("main", f"vit_quantized (published flags): {out_pub['metrics']}, "
                  f"{pub_ms:.2f} ms/img over {out_pub['images']} images, "
                  f"launches {pub_counts}, result {out_pub['result_file']}")
    if any(pub_counts.values()) or not np.isfinite(out_pub["metrics"]["loss"]):
        raise SystemExit("published validate-quantized launched a kernel or gave bad metrics")
    serving = {mode: run_serving(cli, counters, mode) for mode in SERVING_FLAGS}
    # MobileNetV2 and ResNet-18/50 at full width, batch 16, and ViT-B/16's
    # uniform serving at the same batch
    t_cnn = time.perf_counter()
    cnn = {f"{arch} {mode}": run_cnn(cli, counters, arch, mode) for arch, mode in CNN_RUNS}
    cnn_s = time.perf_counter() - t_cnn

    # K1, K2 and K4 checked and timed at the shapes of one batch-8 forward
    times = time_serving_kernels(fm, dm, dev, gemm_err)
    times["K3"] = k3_times

    # Llama-3-8B served by ContinuousBatcher; K7 and K6 checked and timed at
    # the shapes each run gave them
    llama_spec, llama = run_llama_serving(dev, counters)
    times.update(time_llama_attention(llama_spec, dev, llama["fast"], False, gemm_err))
    times["K6 codes"] = time_llama_attention(llama_spec, dev, llama["packed"], True,
                                             gemm_err)["K6"]
    # K2 and K4 at the Llama projection shapes: decode steps and admissions
    llama_gemms = time_llama_gemms(llama_spec, dev, llama["fast"], gemm_err)
    # the same served in w4a8 through K5, timed at the shapes it gave K5
    llama["w4a8"] = run_llama_w4a8(dev, counters)
    times["K5"] = time_llama_k5(llama_spec, dev, llama["w4a8"], gemm_err)

    # 5. whole-model checks at full width, depth 2, batch 1
    depth2 = dataclasses.replace(VIT_B_16, num_layers=2)
    check_model(cli, APPROX_FLAGS, dev, depth2)
    check_serving_model(cli, dev, depth2, counters)
    check_vit_fused(cli, dev, depth2, counters)
    t0 = time.perf_counter()
    check_cnn_models(cli, dev, counters)
    check_cnn_serving(cli, dev, counters)
    cnn_s += time.perf_counter() - t0
    check_llama_model(dev, counters)
    check_llama_uniform(dev, counters)

    # launches: each kernel's count in the main-path run that drives it in
    # the configuration timed above (K4: bf16 x, as --packed-weights runs it;
    # K6: the bf16 cache, as the FAST Llama run reads it)
    kernels = [
        ("quantize_block", "K1", "fused_matmul.cu", "fused_matmul.py:39",
         serving["fast"][2]["K1"], gemm_err["K1"]),
        ("fused_quant_matmul", "K2", "fused_matmul.cu", "fused_matmul.py:115",
         serving["fast"][2]["K2"], gemm_err["K2"]),
        ("approx_matmul", "K3", "approx_matmul.cu", "approx_matmul.py:248",
         approx_counts["K3"], max_err),
        ("dequant_matmul", "K4", "dequant_matmul.cu", "dequant_matmul.py:269",
         serving["packed"][2]["K4"], gemm_err["K4"]),
        # per w4a8 serving run of Llama-3-8B
        ("int4_matmul", "K5", "int4_matmul.cu", "dequant_matmul.py:78",
         llama["w4a8"]["counts"]["K5"], gemm_err["K5"]),
        # per FAST serving run of Llama-3-8B (bf16 cache)
        ("decode_attention", "K6", "decode_attention.cu", "decode_attention.py:101",
         llama["fast"]["counts"]["K6"], gemm_err["K6"]),
        ("fused_sdpa", "K7", "attention.cu", "attention.py:136",
         llama["fast"]["counts"]["K7"], gemm_err["K7"]),
    ]
    record = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"fp8_quantization_tpu_torch/csrc/{src}",
        "replaces": f"fp8_quantization_tpu/ops/pallas/{tpu}",
        "launches": launches,
        "max_abs_err": err,
        "ms": times[key]["ms"],
        "plain_ms": times[key]["plain_ms"],
        "bound_ms": times[key]["bound_ms"],
        "bound_by": times[key]["bound_by"],
        "library_ms": times[key].get("library_ms"),
        # K2, K4 and K6 also per Llama-3-8B decode step (K2/K4: M = 4, route
        # A), K7 also per batch-8 ViT-B/16 forward
        **({"per_decode_step": {f: llama_gemms[key]["step"][f] for f in
                                ("launches", "ms", "bound_ms", "bound_by", "library_ms")}}
           if key in llama_gemms else {}),
        **({"per_decode_step": times[key]["per_decode_step"]} if key == "K6" else {}),
        **({"per_vit_forward": {f: k7_vit[f] for f in
                                ("launches", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}} if key == "K7" else {}),
        # the CNN runs of phase 4 (launches per run) and K3 per batch-16 CNN forward
        **({"cnn_launches": {run: c[2][key] for run, c in cnn.items() if c[2][key]}}
           if key in ("K1", "K2", "K3", "K4", "K5") else {}),
        **({"per_cnn_forward": {arch: {f: t[f] for f in ("launches", "ms", "bound_ms",
                                                          "bound_by")}
                                for arch, t in k3_cnn.items()}} if key == "K3" else {}),
    } for name, key, src, tpu, launches, err in kernels]}
    step = "; ".join([f"{key} {t['step']['ms']:.3f} ms (bound {t['step']['bound_ms']:.3f}, "
                      f"torch.matmul {t['step']['library_ms']:.3f})"
                      for key, t in llama_gemms.items()]
                     + [f"{key} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, SDPA "
                        f"{t['library_ms']:.4f})" for key, t in
                        (("K6", times["K6"]["per_decode_step"]),
                         ("K6 codes", times["K6 codes"]["per_decode_step"]))])
    per_forward = "; ".join(
        f"{key} {t['ms']:.3f} ms (plain {t['plain_ms']:.3f}, bound {t['bound_ms']:.3f}"
        + (f", library {t['library_ms']:.3f}" if t.get("library_ms") is not None else "")
        + ")" for key, t in sorted(times.items()))
    served = "; ".join(
        f"Llama-3-8B {mode}: prefill {r['prefill_tok_s']:.1f} tok/s, decode "
        f"{r['decode_tok_s']:.2f} tok/s, median step {r['step_ms_median']:.2f} ms, peak "
        f"{r['peak_gb']:.2f} GB" for mode, r in llama.items())
    phase("done", f"ms/img: approx {approx_ms:.2f}, published {pub_ms:.2f}, "
                  + ", ".join(f"{mode} {serving[mode][1]:.2f}" for mode in SERVING_FLAGS)
                  + "; CNN ms/img at batch 16: "
                  + ", ".join(f"{run} {c[1]:.2f}" for run, c in cnn.items())
                  + f" (CNN runs and checks {cnn_s:.1f} s); int8 conv sums per batch-16 "
                  "forward: " + ", ".join(
                      f"{arch} {t['ms']:.3f} ms (cuDNN f32 {t['library_ms']:.3f}, bound "
                      f"{t['bound_ms']:.3f})" for arch, t in int8_conv.items())
                  + f"; {served}; per batch-{BATCH} forward (K1-K4) or serving run (K5, K6, "
                  "K7): "
                  f"{per_forward}; K7 per batch-{BATCH} ViT-B/16 forward {k7_vit['ms']:.4f} ms "
                  f"(SDPA {k7_vit['library_ms']:.4f}, bound {k7_vit['bound_ms']:.4f}); per "
                  f"Llama-3-8B decode step: {step}; "
                  f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
