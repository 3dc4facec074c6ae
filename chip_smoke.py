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
   quantizer (K1) on random, zero, subnormal, +-maxval and clip-edge inputs,
   also at every mantissa width the MSE search elects (E6M1 ... E1M6, sign 1
   and 0), with the two routes of K2 and K4 at each of those widths;
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
   cuDNN's f32 convolution of the same codes; K3 at the surgery model's
   three distinct (K, N) on a 64-row slice, equal to its plain version, then
   timed at every product of its batch-16 forward beside its bound; K2 and
   K4 at its dense shapes (16 rows: route A; a 64-row slice: route B) and
   the demo's 8x10x10; the int8 sums of its Conv1d and input-dilated
   ConvTranspose1d (zero point's code 0 and -128 in holes and pads) equal
   to the CPU's; K2 and K4 at BERT-base's shapes at 32 x 128 (the 4096-row
   products 4096 x 768 x 768, x 3072 and 4096 x 3072 x 768, the 32-row pooler
   and the 2-column classifier, route B), then timed at every product of
   that forward beside their plain versions, ``torch.matmul`` and the
   bound. At the shapes of a batch-8 forward, in the configurations the main
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
   Then the FP8 paper's MSE range setting on the same flags (MSE weights and
   acts, the mantissa-width election, two calibration batches): published,
   ``--fast-mode`` (K1, K2 at the elected widths) and ``--fast-mode
   --packed-weights --fp8-mantissa-bits 6`` (K4 at E1M6, the width every
   dense weight elects, on every dense layer), and without the election
   under ``--fast-mode --packed-weights`` (every dense layer on K4 at
   E3M4): each with its calibration
   seconds, ms/img, the elected-width histograms, the packed layers, every
   site's maxval finite and > 0, and the launches the sites' formats imply;
   then quantize-after-mult-and-add and the approximate multiplier with the
   OF/UF adder (plain PyTorch: ``qama_matmul_2d`` and the oracle on every
   product, no kernel), one eval batch of ``ORACLE_BATCH`` images each (the
   oracle takes ~9.5 s an image), the oracle's top-1 agreement printed
   against a K3 run of the same flags and batch size (the same calibration
   and eval images).
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
   Then the real-weights, images, demo and surgery runs: ``validate-quantized-demo`` (``demo_quantized``,
   published, approx (K3), ``--fast-mode`` (K1, K2), ``--packed-weights``
   (K1, K2, K4)), each held to a plain run of the same flags; a
   ``QuantizedSequential`` of every new layer kind on 16 x 1024 x 64 (a
   Conv1d, a stride-2 ConvTranspose1d with torch's padding and output
   padding, an average pool with its own site, a tied
   ``QuantizedActWrapper`` pool, a BNQuantDense and a Linear) through
   ``eval.driver.validate_quantized``: approx, fast, packed and FP8 chained
   logits equal to the plain versions' on the card, int8 packed and
   chained within ``RMS_LIMIT`` of the CPU's; ``--model-dir`` on seeded
   FP32 state dicts written under the sources' own names (HF ViT-B/16,
   torchvision ResNet-18/50, the reference's MobileNetV2): every tensor
   read but the BN counters, every ported entry equal to the file's after
   its layout change, logits unlike a seeded-init run's; ViT-B/16
   ``--fast-mode --packed-weights`` saved with ``--save-checkpoint-dir`` and
   restored through ``--model-dir`` with every buffer equal; and
   ``--images-dir`` on a folder of JPEG and PNG images it writes, through
   the PIL pipeline and, where ``runtime/image_loader.cc`` builds,
   ``--native-loader`` (within the PIL pipeline's tolerance); what is
   missing for it is printed. Each run's launches equal the counts its
   shapes imply.
   Then BERT-base at full width (12 layers, seeded weights): ``python -m
   fp8_quantization_tpu_torch.nlp`` three ways, on the synthetic task under
   the published E5M2 flags, with ``--model-dir`` on a seeded state dict
   under HF ``BertForSequenceClassification``'s names (every tensor read and
   ported as the file holds it; its load and porting seconds, timed beside
   the run) and with
   ``--data-dir`` on a written SST-2 folder and ``vocab.txt``, each
   launching no kernel; then ``scripts/bench_bert.py``'s serving modes on
   its ragged 32 x 128 batch: fp32, fixed, fast (K1, K2), FP8 packed (K1,
   K4), and the int8 configuration's fast, int8 packed and int8 chained
   (no kernel; ``torch._int_mm``), each with its launches held to the
   counts the model implies, its ms a batch (CUDA events, median of 5) and
   its busy share, the int8 modes' top-1 agreement with that fast at least
   0.95. The BERT phases print their own wall time.
   Then ``train-qat`` on MobileNetV2 at full width (224, 1000 classes),
   batch 32, synthetic data, 2 epochs of 4 steps: (a) the published flags
   with ``--fp8-learn-maxval --sep-quant-optimizer`` and (b) 4-bit
   symmetric per-channel weights, 8-bit acts, ``--grad-scaling`` and the
   oscillation flags (``OSC_FLAGS``); each launches no kernel, has a finite
   loss every step, saves a ``latest`` checkpoint that restores to equal
   logits, and (a) moves trainable ``maxval`` entries, (b) freezes weights,
   every frozen one keeping its code after every step; then the timing
   ladder after ``scripts/bench_qat.py`` at (a)'s shapes: plain f32
   training, fake-quant training with frozen ranges and QAT with learnable
   ranges, each its ms a step (CUDA events, median of 5), device launches
   and busy share.
   Then a foreign plain-PyTorch ViT-B/16 (HF ``ViTForImageClassification``'s
   module names, seeded weights loaded strictly) quantized by interception
   (``models.flax_surgery.quantize_flax_model``) under the published flags
   with the approximate multiplier, batch 8: one calibration and two eval
   batches (K3 74 times a forward, K1/K2/K4 never; ms/img), every K3 call
   of one forward against its plain version on 64 rows of its own operands,
   layer 0's ``intermediate.dense`` (1576 x 768 x 3072) bit-equal to a port
   ``QuantDense`` holding its kernel and site state, the FP32 phase bit-equal
   to the foreign model, a ``filter_fn`` without the patch conv and the
   classifier (K3 72 times), one forward under ``utils/profiling.trace`` (74
   K3 kernel events, their device ms beside the port ViT's and K3's bound,
   ``device_peaks`` the H100's, ``roofline``), and depth 2 at batch 1 through
   K3 and its plain version; rank-3 ``QuantConv`` (3x3x3, 64 -> 64 on 2 x 8
   x 28 x 28 x 64) and ``QuantConvTranspose`` (2x2x2 stride 2, 64 -> 32):
   approx through K3 (each call held on 64 rows of its patches),
   ``--fast-mode``, packed and FP8 chained (K1 twice a forward), FIXED on
   the card against the CPU, and the int8 sums against the CPU's (zero
   point's code 0 and -128); ``fp8_grid_check`` on the card.
   Then ``ContinuousBatcher`` serving Llama-3-8B at full width (32 layers,
   seeded random weights, calibrated as ``scripts/bench_llama.py`` does) with
   ``fused_sdpa=True``: 4 slots of 2048, greedy, prompts of 17, 100, 256 and
   511 tokens and a fifth of 64 admitted when a slot retires, 32 new tokens
   each; under FAST with a bf16 cache (K1, K2, K7, K6) and under PACKED with
   a uint8 cache (K1, K4, K7, K6 on codes). Under each, a ``PrefixCache``
   run: four prompts of one 256-token head and tails of 17-100 tokens, 1
   miss and 3 hits whose admissions splice the head and prefill the tail
   over the slab (K7 with offsets), held to a cold run of the same prompts
   (their rows within ``RMS_LIMIT``, the tokens while decided; whether they
   are bit-equal is printed), with the warm and cold admission ms. Under
   FAST, greedy speculative runs (k = 4, 4 slots, 16 tokens) with a
   self-draft and with a draft at Llama-3.2-1B's published widths (seeded
   weights; K6 and K2 route A for the draft decodes, K7 with offsets and
   route B for the 20-row verify): tokens and logit rows equal bit for bit
   to a plain run whose decode steps take the verify's route, acceptance,
   tokens a slot a round, the round's ms split into draft decodes and
   verify, and the peak memory with the draft beside the target. Then
   ``PagedBatcher`` over 129 pages of 16 tokens, FAST (bf16 pool) and,
   after packing, PACKED (uint8 pool): the same prompts and schedule, held
   bit for bit (tokens and every logit row) to a dense run whose decodes
   take the einsum route a paged decode takes (``einsum_route``: no K6),
   the late prompt reusing pages a retired slot freed and the peak memory
   below the dense run's, with the median steps (paged, dense einsum,
   dense K6), peak memory, pages in use at the peak and the gather's and
   scatter's device ms a step (``torch.profiler``); the prefix prompts
   through pages, warm rows bit-equal to cold ones; and the self-draft
   speculative run through pages, three admissions warm (64-token entries
   a paged batcher stored), bit-equal to the dense speculative run,
   acceptance included. Then, that model freed, built
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
   within ``RMS_LIMIT``); the MSE-calibrated ViT under FAST (K1 and K2 at
   the elected widths, every call held on its own inputs, the logits within
   ``RMS_LIMIT``), its searches run again on the host from the inputs the
   sites saw on the card (a sample of the sites; those that elect another
   width or maxval counted); Llama-3-8B under FAST+fused and
   PACKED+packed_kv+fused (every K2/K4 and K7 call held to its contract and
   every K1 call to equality; prefill logits within ``RMS_LIMIT``; prefill
   argmax, and the greedy tokens of two prompts through the batcher, equal
   where the plain top-1/top-2 margin is at least twice the prefill logits'
   max |d|, at least one such token compared; with the admissions through
   the plain versions, the kernels' decode steps give the plain run's
   logits and tokens exactly); in both, one warm admission and one
   speculative round (a self-draft, a ``PrefixCache``) with every K1,
   K2/K4 and K7 call held on its own inputs and the launches the shapes
   imply. ``RMS_LIMIT`` lies between the relative RMS
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
   top-1 agreement of at least 0.9 and near ties only where it differs;
   a depth-2 full-width BERT at 32 x 128 (ragged): FAST and FP8 PACKED
   through the kernels (every K2/K4 call to its contract, every K1 call
   equal) against the plain versions (relative RMS within ``RMS_LIMIT``
   and midway between the plain path's legal-order and lower-precision
   readings, same top-1 where the plain margin is decided), FAST against
   FIXED within ``RMS_LIMIT``, and
   int8 CHAINED against PACKED within ``rtol = atol = 5e-4`` with the same
   top-1. (Run inside phase 4's QAT phase:) one QAT step of MobileNetV2 at
   full width cut to one block a stage, batch 2, on the card and on the CPU
   from one calibrated state: the relative RMS of the weight and range
   updates within ``RMS_LIMIT``.

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

from fp8_quantization_tpu_torch.utils.profiling import PEAKS

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth (written once,
# in utils/profiling.PEAKS) and float32 outside the tensor cores. The float32
# rate counts an FMA as two operations, so the CUDA cores do half as many
# f32 adds a second
H100 = "H100 80GB HBM3"
HBM_BYTES_PER_S = PEAKS[H100]["hbm_gbps"] * 1e9
F32_OPS_PER_S = 67e12
F32_ADDS_PER_S = F32_OPS_PER_S / 2
# shared memory serves 32 four-byte words a clock on each SM: K3's floor is
# one table read a product (csrc/approx_matmul.cu)
SHARED_WORDS_PER_SM_CLOCK = 32
# dense bf16 tensor-core peak: the least time for a GEMM's 2MKN operations
BF16_TC_OPS_PER_S = PEAKS[H100]["bf16_tflops"] * 1e12

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


# the mantissa widths the MSE search elects among on a signed 8-bit grid
# (E6M1 ... E1M6), each with its own bias and subnormal edge
ELECTED_WIDTHS = tuple(range(1, 7))
# K2 and K4 at every width: route A (decode-sized M) and route B
WIDTH_GEMM_ROWS = (16, SLICE_ROWS)


def check_widths(fm, dm, dev):
    """K1 and both routes of K2 and K4 at every width the MSE search can
    elect, against their plain versions: K1 equal on the edge inputs of
    :func:`k1_inputs`, sign 1 and 0; K2 and K4 (f32 x quantized on the load
    and bf16 x, with and without the requant, at 768 x 768; K4's weights
    packed as E(7-M)M codes) route A equal and route B within
    ``within_requant_step``, the act and res scalars and the weights on the
    same width. Returns the worst |d| of each."""
    from fp8_quantization_tpu_torch.numerics.fp8_ste import quantize_to_fp8_ste

    rng = np.random.default_rng(13)
    worst = {"K1": 0.0, "K2": 0.0, "K4": 0.0}

    def bias_of(maxval, mant, sign):
        return int(quantize_to_fp8_ste(torch.zeros(1), 8, torch.tensor([maxval]), float(mant),
                                       sign)[1][0])

    for mant in ELECTED_WIDTHS:
        for sign in (1, 0):
            x = torch.from_numpy(k1_inputs(rng, 3.0)).to(dev)
            bias = torch.tensor(float(bias_of(3.0, mant, sign)), device=dev)
            ours = fm.quantize_block(x, torch.tensor(3.0, device=dev), bias, mant, sign)
            plain = fm.quantize_block_plain(x, 3.0, bias, mant, sign)
            worst["K1"] = max(worst["K1"], float((ours - plain).abs().nan_to_num(0.0).max()))
            if not torch.equal(ours, plain):
                raise SystemExit(f"K1 differs from its plain version at width {mant}, sign {sign}")
        act = device_qscalars(dev, 4.0, bias_of(4.0, mant, 1), mant, 1)
        res = device_qscalars(dev, 8.0, bias_of(8.0, mant, 1), mant, 1)
        fractions, routes = [], []

        def hold(name, run, plain_sum, x_eff, w_eff, what):
            for requant in (False, True):
                ours = run(requant)
                plain_q = fm.quantize_block_plain(plain_sum, *res) if requant else plain_sum
                route, ok, frac = gemm_verdict(fm, ours, plain_sum, x_eff, w_eff,
                                               res if requant else None, plain_q)
                worst[name] = max(worst[name], float((ours - plain_q).abs()
                                                     .nan_to_num(0.0).max()))
                fractions.append(frac)
                if not ok:
                    raise SystemExit(f"{name} route {route} breaks its contract at width {mant} "
                                     f"({what}, requant={requant})")
            return route

        for m in WIDTH_GEMM_ROWS:
            x, wq, w_bias = gemm_operands(m, 768, 768, dev, seed=100 * mant + m, mant=mant)
            w16 = wq.to(torch.bfloat16)
            xq = fm.quantize_block_plain(x, *act)
            for quantize_x in (True, False):
                xin = x if quantize_x else xq.to(torch.bfloat16)
                plain_sum = fm.fused_quant_matmul_plain(xin, w16, act, quantize_x=quantize_x)
                route = hold("K2", lambda rq: fm.fused_quant_matmul(
                    xin, w16, act, res, quantize_x=quantize_x, requantize_out=rq),
                    plain_sum, xq, wq, f"quantize_x={quantize_x}")
            pw = dm.pack_weights(wq, w_bias, 7 - mant, mant)
            w_eff = dm.unpack_weights(pw)
            for what, xin, xkw in (("bf16 x", xq.to(torch.bfloat16), {}),
                                   ("f32 x quantized", x, dict(quantize_x=True,
                                                               act_params=act))):
                kw = dict(expo_width=7 - mant, mant_width=mant, **xkw)
                plain_sum = dm.dequant_matmul_plain(xin, pw.codes, pw.bias, **kw)
                hold("K4", lambda rq: dm.dequant_matmul(
                    xin, pw.codes, pw.bias, res_params=res, requantize_out=rq, **kw),
                    plain_sum, xq, w_eff, what)
            routes.append(route)
        phase("kernels", f"width E{7 - mant}M{mant}: K1 equal to plain (sign 1 and 0); K2 and "
                         f"K4 at {'/'.join(map(str, WIDTH_GEMM_ROWS))} x 768 x 768 routes "
                         f"{routes} within contract (min equal fraction {min(fractions):.4f}); "
                         f"worst |d| K1 {worst['K1']:.3g}, K2 {worst['K2']:.3g}, "
                         f"K4 {worst['K4']:.3g}")
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


def check_gemms(fm, dm, dev, shapes=GEMM_CHECK_SHAPES):
    """K2 and K4 against their plain versions in every switch combination
    (K2: f32 x quantized on the load and bf16 x; K4: bf16, f32 quantized,
    f32 and coded x; requant or not; f32 or bf16 out) at
    ``shapes``: route A (M <= 16) equal to the plain version, route
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

    for m, k, n in shapes:
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
    out.update(time_dense_gemms(fm, dm, dev, worst, dense_shapes(BATCH), coded=True))
    return out


def time_dense_gemms(fm, dm, dev, worst, shapes, coded):
    """K2 on bf16 x and K4 on bf16 x (and, with ``coded``, on coded x as
    ``--chained-acts`` runs it) at each ``(name, M, K, N, count)`` of
    ``shapes``, summed over one forward: held against the plain version once
    more (``worst`` takes the errors), then timed with their plain versions,
    cuBLAS on the same bf16 operands (weights pre-decoded for K4) and the
    bound. Returns {"K2", "K4"[, "K4 coded x"]}."""
    from fp8_quantization_tpu_torch.numerics.codec import pack_exmy, unpack_exmy

    k2, k4, k4c = {}, {}, {}
    act = (4.0, 4, 4, 1)
    for name, m, k, n, count in shapes:
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
        if not coded:
            phase("kernels", f"K4 {shape}: route {fm.gemm_route(m)}, within its contract with "
                             f"plain on bf16 x; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                             f"cuBLAS {lib_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
                             f"({2 * m * k * n / ms / 1e9:.4g} TFLOP/s)")
            continue
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
    out = {"K2": _finish(k2), "K4": _finish(k4)}
    if coded:
        out["K4 coded x"] = _finish(k4c)
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


def _flags(argv, **values):
    """``argv`` with the value after each ``--flag`` replaced (keys with
    ``_`` for ``-``) and any ``old=new`` flag swap under ``swap``."""
    out = list(argv)
    for swap_from, swap_to in values.pop("swap", {}).items():
        out = [swap_to if f == swap_from else f for f in out]
    for key, value in values.items():
        i = out.index("--" + key.replace("_", "-"))
        out[i + 1] = str(value)
    return out


# The FP8 paper's MSE range setting on the published flags: MSE weights and
# activations with the mantissa-width election (the CLI's default
# --fp8-mse-include-mantissa-bits), two calibration batches (the first
# chooses the search grids, the second adds to their MSEs)
MSE_FLAGS = _flags(PUBLISHED_FLAGS, weight_quant_method="MSE", act_quant_method="MSE",
                   num_est_batches=2, swap={"--no-fp8-mse-include-mantissa-bits":
                                            "--fp8-mse-include-mantissa-bits"})
MSE_RUNS = {
    "mse published": MSE_FLAGS,
    "mse fast": MSE_FLAGS + ["--fast-mode"],
    # _pack_fp packs a layer whose elected width is --fp8-mantissa-bits:
    # with random weights every dense weight elects E1M6
    "mse packed": _flags(MSE_FLAGS, fp8_mantissa_bits=6) + ["--fast-mode", "--packed-weights"],
    # every dense layer at --fp8-mantissa-bits (E3M4): all pack
    "mse fixed-width packed": _flags(MSE_FLAGS, swap={
        "--fp8-mse-include-mantissa-bits": "--no-fp8-mse-include-mantissa-bits"})
    + ["--fast-mode", "--packed-weights"],
}
MSE_EVALS = 2
# the plain-PyTorch run methods on the published flags (and the approx
# ones), one eval batch each, of fewer images: the OF/UF oracle takes ~9.5 s
# an image on the card (PERF.md §6). The OF/UF run is held against a
# K3 run of the same flags and batch size: the same calibration and images.
# One image a batch keeps the whole script well inside its time limit on a
# slow host (two took ~20 s more)
ORACLE_EVALS = 1
ORACLE_BATCH = 1
K3_ORACLE_FLAGS = _flags(APPROX_FLAGS, max_eval_batches=ORACLE_EVALS, batch_size=ORACLE_BATCH)
QAMA_FLAGS = _flags(PUBLISHED_FLAGS, max_eval_batches=ORACLE_EVALS, batch_size=ORACLE_BATCH,
                    swap={"--no-quantize-after-mult-and-add": "--quantize-after-mult-and-add"})
OFUF_FLAGS = K3_ORACLE_FLAGS + [
    "--sim_hw_add_OFUF", "--with_OF_opt", "--with_UF_opt"]


@contextlib.contextmanager
def captured_runs(cli, record):
    """Records, for every ``validate-quantized`` run inside, the model
    (``record["model"]``), the wall seconds of its calibration
    (``record["calib_s"]``, synced) and the f32 logits of its eval batches
    on the host (``record["logits"]``)."""
    from fp8_quantization_tpu_torch.eval import driver

    setup, calibrate, update = cli.setup, driver.calibrate, driver.update_metrics
    record.update(logits=[])

    def setup_call(args):
        out = setup(args)
        record["model"] = out[0]
        return out

    def calibrate_call(model, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = calibrate(model, *args, **kw)
        torch.cuda.synchronize()
        record["calib_s"] = time.perf_counter() - t0
        return out

    def update_call(state, logits, labels, **kw):
        record["logits"].append(logits.float().cpu())
        return update(state, logits, labels, **kw)

    cli.setup, driver.calibrate, driver.update_metrics = setup_call, calibrate_call, update_call
    try:
        yield record
    finally:
        cli.setup, driver.calibrate, driver.update_metrics = setup, calibrate, update


def site_report(model):
    """The elected widths of a calibrated model: histograms over the weight
    sites and over the act/res sites, the dense layers packed (K4) and
    unpacked (K2), and whether every site's ``maxval`` is finite and > 0."""
    from collections import Counter

    from fp8_quantization_tpu_torch.ops.layers import QuantDense
    from fp8_quantization_tpu_torch.quant.sites import QuantSite

    weights, acts, bad = Counter(), Counter(), []
    for name, m in model.named_modules():
        if isinstance(m, QuantSite):
            width = int(torch.round(m.mantissa_bits[0]))
            (weights if name.endswith("weight_quantizer") else acts)[width] += 1
            mv = m.maxval
            if not bool(torch.isfinite(mv).all() and (mv > 0).all()):
                bad.append(name)
    dense = [m for m in model.modules() if isinstance(m, QuantDense)]
    packed = sum(m.w_codes is not None for m in dense)
    return {"weight_widths": dict(sorted(weights.items())),
            "act_widths": dict(sorted(acts.items())), "dense": len(dense), "packed": packed,
            "bad_maxval": bad}


def run_mse(cli, counters, name):
    """One MSE ``validate-quantized`` run of ``MSE_RUNS`` with the counts
    zeroed just before it: the calibration seconds, ms/img, the elected
    widths, the packed layers, every site's maxval finite and > 0, and the
    launches held to the counts the sites' formats imply (K1 at every
    per-tensor site, K2 on every unpacked dense product, K4 on every packed
    one)."""
    argv = MSE_RUNS[name]
    zero_counts(counters)
    with captured_runs(cli, {}) as rec:
        out, ms = run_cli(cli, argv)
    counts = read_counts(counters)
    report = site_report(rec.pop("model"))
    fast = "--fast-mode" in argv
    packing = "--packed-weights" in argv
    packed = report["packed"] if packing else 0
    want = {key: 0 for key in counts}
    if fast:
        # --packed-weights first caches the weights in one forward of the
        # example batch, every dense product on K2
        want.update(K1=K1_LAUNCHES_PER_FORWARD * (MSE_EVALS + packing),
                    K2=(DENSE_LAUNCHES_PER_FORWARD - packed) * MSE_EVALS
                    + DENSE_LAUNCHES_PER_FORWARD * packing,
                    K4=packed * MSE_EVALS)
    eval_imgs = out["images"] - BATCH * 2
    eval_ms = 1e3 * (out["validate_s"] - rec["calib_s"]) / eval_imgs
    phase("main", f"vit_quantized {name}: {out['metrics']}, calibration "
                  f"{rec['calib_s']:.2f} s over 2 batches of {BATCH}, {ms:.2f} ms/img over "
                  f"{out['images']} images (eval {eval_ms:.2f} ms/img; {card_power()}); elected "
                  f"widths: weight sites {report['weight_widths']}, act/res sites "
                  f"{report['act_widths']}; dense layers packed (K4) {packed}, on K2 "
                  f"{report['dense'] - packed if fast else 0}; sites with a bad maxval "
                  f"{report['bad_maxval']}; launches {counts} (expected {want})")
    if (counts != want or report["bad_maxval"] or not np.isfinite(out["metrics"]["loss"])
            or report["dense"] != DENSE_LAUNCHES_PER_FORWARD):
        raise SystemExit(f"{name} validate-quantized: wrong launch counts, a bad maxval or "
                         "bad metrics")
    if packing and packed != DENSE_LAUNCHES_PER_FORWARD:
        raise SystemExit(f"{name}: a dense layer stayed unpacked")
    return {"ms": ms, "eval_ms": eval_ms, "calib_s": rec["calib_s"], "counts": counts,
            **report}


def run_k3_oracle_batch(cli, counters):
    """``K3_ORACLE_FLAGS``: the approx run method through K3 on the OF/UF
    run's calibration and eval images; returns its eval logits."""
    zero_counts(counters)
    with captured_runs(cli, {}) as rec:
        out, ms = run_cli(cli, K3_ORACLE_FLAGS)
    counts = read_counts(counters)
    rec.pop("model")
    want = LAUNCHES_PER_FORWARD * (1 + 1 + ORACLE_EVALS)
    phase("main", f"vit_quantized_approx at batch {ORACLE_BATCH}: {out['metrics']}, "
                  f"{ms:.2f} ms/img over {out['images']} images, launches {counts} (K3 "
                  f"expected {want})")
    if counts["K3"] != want or not np.isfinite(out["metrics"]["loss"]):
        raise SystemExit("approx validate-quantized at the oracle's batch: wrong launch count "
                         "or bad metrics")
    return rec["logits"][0]


def run_special(cli, counters, name, argv, k3_logits):
    """A run method simulated in plain PyTorch, one eval batch: no hand
    kernel launches; quantize-after-mult-and-add calls ``qama_matmul_2d``
    on every dense product and the patch conv, the OF/UF adder the oracle on
    every approximate product (the CLI's init forward, the calibration batch
    and the eval batch). Prints ms/img and, for the oracle, the top-1
    agreement and the logits' relative RMS against the K3 run on the same
    batch."""
    zero_counts(counters)
    with captured_runs(cli, {}) as rec, counted_calls({}, SPECIAL_COUNTED) as calls:
        out, ms = run_cli(cli, argv)
    counts = read_counts(counters)
    rec.pop("model")
    key = "qama" if name == "qama" else "oracle"
    want = LAUNCHES_PER_FORWARD * (1 + 1 + ORACLE_EVALS)
    agree = rms = None
    if k3_logits is not None:
        ours = rec["logits"][0]
        agree = float((ours.argmax(-1) == k3_logits.argmax(-1)).float().mean())
        rms = rel_rms(ours, k3_logits)
    eval_ms = 1e3 * (out["validate_s"] - rec["calib_s"]) / (out["images"] - ORACLE_BATCH)
    phase("main", f"vit_quantized {name}: {out['metrics']}, {ms:.2f} ms/img over "
                  f"{out['images']} images (calibration {rec['calib_s']:.2f} s, eval "
                  f"{eval_ms:.2f} ms/img; {card_power()}), {key} calls {calls[key]} (expected "
                  f"{want}), launches {counts}"
                  + (f", against the K3 run on the same batch: top-1 agreement {agree:.4f}, "
                     f"logits' relative RMS {rms:.4g}" if agree is not None else ""))
    if (any(counts.values()) or calls[key] != want
            or calls["oracle" if key == "qama" else "qama"]
            or not np.isfinite(out["metrics"]["loss"])):
        raise SystemExit(f"{name} validate-quantized: a kernel launched, wrong call counts or "
                         "bad metrics")
    return {"ms": ms, "eval_ms": eval_ms, "calib_s": rec["calib_s"], "agreement": agree,
            "rel_rms": rms}


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


def plain_path_readings(forward, plain_out):
    """The relative RMS of the same forward (``forward()``) through the
    plain path in each of ``GEMM_SUM_ORDERS`` against the plain output
    ``plain_out``: (legal order, lower-precision control)."""
    readings = []
    for order in GEMM_SUM_ORDERS:
        with plain_path(order):
            readings.append(rel_rms(forward(), plain_out))
    return tuple(readings)


def rms_verdict(rms, forward, plain_out):
    """Holds a kernel run's relative RMS ``rms`` against the plain output
    ``plain_out`` to ``RMS_LIMIT``, after reading the same forward
    (``forward()``) through the plain path in each of ``GEMM_SUM_ORDERS``.
    Returns (ok, a line saying so)."""
    legal, control = plain_path_readings(forward, plain_out)
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
# the prefix runs: four prompts of one 256-token head and a unique tail each
PREFIX_SHARED = 256
PREFIX_TAILS = (17, 42, 71, 100)
PREFIX_NEW_TOKENS = 8
# the speculative runs: greedy, k = 4, the first four prompts
SPEC_K = 4
SPEC_NEW_TOKENS = 16
# the paged runs: pages of 16 tokens, 128 usable pages (2,048 token rows, one
# slot's max_seq) and the trash page
LLAMA_PAGE = 16
LLAMA_PAGES = LLAMA_MAX_SEQ // LLAMA_PAGE + 1


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


def expected_counts(counters, per_forward, forwards, k6=0, k7=0):
    """Each kernel's launches in a run of ``forwards`` forwards that each
    launch ``per_forward`` (kernel -> count), with K6 and K7 given; every
    other kernel none."""
    expected = {key: 0 for key in counters}
    expected.update({key: n * forwards for key, n in per_forward.items()})
    expected.update(K6=k6, K7=k7)
    return expected


def serve_llama(name, model, spec, qp, counters, dev, per_forward, batcher=None, k6=True,
                record=False, new_tokens=LLAMA_NEW_TOKENS, uncounted=None):
    """Phase 4: the four prompts, then the fifth into the first slot that
    retires, ``new_tokens`` (32) greedy tokens each, with every launch count
    zeroed just before; the counts must be the ones the run's shapes imply: K7 once a
    layer per admission, K6 once a layer per step (none with ``k6`` False:
    a ``PagedBatcher``, or the dense batcher under ``einsum_route``),
    ``per_forward`` (kernel -> launches) per forward and no other kernel.
    ``batcher``: the batcher to serve with (default a dense
    ``ContinuousBatcher``). ``record``: keep each request's logit rows (its
    admission's last prompt row, then each step's) for the bit-for-bit
    comparisons. A ``PagedBatcher`` run also records the pages in use at the
    peak and the pages the late prompt took from the slot retired before
    it. ``uncounted``: kernel -> calls that a caller routed to the plain
    version during the run (read after it), taken off the expected counts.
    Returns the run's record: stats, counts and the shapes the kernels
    saw."""
    from fp8_quantization_tpu_torch.models.paged_kv import PagedBatcher
    from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher, _pad_to_bucket

    prompts = llama_prompts(spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    if batcher is None:
        batcher = ContinuousBatcher(model, spec, slots=LLAMA_SLOTS, max_seq=LLAMA_MAX_SEQ,
                                    qp=qp)
    paged = isinstance(batcher, PagedBatcher)
    run = {"prefill_s": 0.0, "prefill_tokens": 0, "step_s": [], "step_tokens": 0,
           "chunks": [], "step_lengths": [], "outputs": {}, "rows": {}, "peak_pages": 0,
           "late_reused": None}
    last = {}
    if record:
        target = batcher.model

        def recording(tokens, cache, qp_, chunk_attention=False):
            logits, cache = target(tokens, cache, qp_, chunk_attention=chunk_attention)
            last["logits"] = logits
            return logits, cache

        batcher.model = recording
    zero_counts(counters)

    def admit(prompt, request):
        t0 = time.perf_counter()
        slot = batcher.admit(prompt, max_new_tokens=new_tokens)        # reads a token: syncs
        run["prefill_s"] += time.perf_counter() - t0
        run["prefill_tokens"] += len(prompt)
        run["chunks"].append(_pad_to_bucket(len(prompt)))
        if record:
            # a copy, and the chunk's logits dropped, so that the peak
            # memory is the batcher's own
            run["rows"][request] = [last.pop("logits")[0, len(prompt) - 1].float().clone()]
        if paged:
            run["peak_pages"] = max(run["peak_pages"], batcher.pages_in_use)
        return slot

    owner = {admit(p, i): i for i, p in enumerate(prompts[:-1])}
    late = prompts[-1]
    while True:
        lengths = batcher._lengths()
        t0 = time.perf_counter()
        out = batcher.step()                                            # reads tokens: syncs
        if not out:
            break
        run["step_s"].append(time.perf_counter() - t0)
        run["step_tokens"] += len(out)
        run["step_lengths"].append(lengths)
        if record:
            logits = last.pop("logits")
            for slot in out:
                run["rows"][owner[slot]].append(logits[slot, -1].float())
        if paged:
            run["peak_pages"] = max(run["peak_pages"], batcher.pages_in_use)
        for slot in [s for s, st in batcher.active.items() if st["done"]]:
            freed = set(batcher.table[slot][batcher.table[slot] > 0].tolist()) if paged else ()
            run["outputs"][owner.pop(slot)] = batcher.retire(slot)
            if late is not None:
                late_slot = admit(late, len(prompts) - 1)
                owner[late_slot] = len(prompts) - 1
                if paged:
                    run["late_reused"] = sorted(freed & set(batcher.table[late_slot].tolist()))
                late = None
    counts = read_counts(counters)
    run["counts"] = counts
    run["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if record:
        batcher.model = target
    steps, admissions = len(run["step_s"]), len(run["chunks"])
    expected = expected_counts(counters, per_forward, steps + admissions,
                               k6=spec.num_layers * steps if k6 else 0,
                               k7=spec.num_layers * admissions)
    for key, n in (uncounted or {}).items():
        expected[key] -= n
    outputs = run["outputs"]
    run["tokens"] = [outputs[i] for i in sorted(outputs)]
    run["rows"] = [run["rows"][i] for i in sorted(run["rows"])]
    ok = (counts == expected and sorted(outputs) == list(range(len(prompts)))
          and all(len(o) == new_tokens and all(0 <= t < spec.vocab_size for t in o)
                  for o in outputs.values()))
    run["prefill_tok_s"] = run["prefill_tokens"] / run["prefill_s"]
    run["decode_tok_s"] = run["step_tokens"] / sum(run["step_s"])
    run["step_ms_median"] = 1e3 * float(np.median(run["step_s"]))
    pages = (f"; {run['peak_pages']} of {batcher.num_pages - 1} pages in use at the peak, the "
             f"late prompt took freed pages {run['late_reused']}" if paged else "")
    phase("main", f"Llama-3-8B {name}: {admissions} admissions ({run['prefill_tokens']} "
                  f"prompt tokens, chunks {run['chunks']}), {steps} decode steps "
                  f"({run['step_tokens']} tokens); prefill {run['prefill_tok_s']:.1f} tok/s, "
                  f"decode {run['decode_tok_s']:.2f} tok/s, median step "
                  f"{run['step_ms_median']:.2f} ms, peak memory {run['peak_gb']:.2f} GB{pages}; "
                  f"launches {counts} (expected {expected}); first tokens "
                  f"{[outputs[i][:4] for i in sorted(outputs)]}; ok={ok}")
    if not ok:
        raise SystemExit(f"Llama {name} serving: wrong launch counts or outputs")
    return run


def profile_decode(name, model, spec, qp, dev, steps=3, batcher=None, ops=()):
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    steps of a batcher (default a dense ``ContinuousBatcher``) holding the
    four prompts (after one unprofiled step). Prints the wall and device
    time per step, the device's busy share, the kernel launches per step,
    the heaviest kernels and the device ms a step of each PyTorch op in
    ``ops`` (the kernels it launched). The profiler's own host cost
    inflates the wall time. Returns {op: device ms per step}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher

    if batcher is None:
        batcher = ContinuousBatcher(model, spec, slots=LLAMA_SLOTS, max_seq=LLAMA_MAX_SEQ,
                                    qp=qp)
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

    def total_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    averages = prof.key_averages()
    # the device's own events: a host op's device time repeats its kernels'
    kernels = sorted((e for e in averages if e.device_type == DeviceType.CUDA
                      and device_us(e) > 0), key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top = "; ".join(f"{e.key[:40]} {device_us(e) / 1e3 / steps:.2f} ms x{e.count // steps}"
                    for e in kernels[:6])
    op_ms = {op: sum(total_us(e) for e in averages if e.key == op) / 1e3 / steps for op in ops}
    op_calls = {op: sum(e.count for e in averages if e.key == op) // steps for op in ops}
    phase("main", f"Llama-3-8B {name} decode step, profiled over {steps} steps at 4 live "
                  f"slots: wall {1e3 * wall / steps:.2f} ms, device {busy_us / 1e3 / steps:.2f} "
                  f"ms (busy share {busy_us / 1e6 / wall:.3f}), {launches // steps} kernel "
                  f"launches per step; heaviest: {top}"
                  + "".join(f"; {op} x{op_calls[op]} {op_ms[op]:.3f} device ms per step"
                            for op in ops))
    return op_ms


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
        check_warm_and_verify(model, spec, qp, dense, counters)


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


# the per-channel weight sites' channels searched again on the host, and
# every HOST_SITE_STRIDE-th per-tensor site (all of them take ~28 s of the
# host's cores at depth 2)
HOST_CHANNELS = 32
HOST_SITE_STRIDE = 3


def host_election(model, inputs):
    """The sites' searches of one MSE calibration batch run again on the
    host, from the same zero state, on the inputs each site saw on the card
    (``inputs``: site name -> tensor on the card): every
    ``HOST_SITE_STRIDE``-th per-tensor site whole, the per-channel (weight)
    sites on their first ``HOST_CHANNELS`` channels. Counts the sampled
    per-tensor sites whose elected width or ``maxval`` differs from the
    card's, and the sampled channels whose best width (its vote) or best
    candidate at the card's elected width differs."""
    from fp8_quantization_tpu_torch.quant import estimators
    from fp8_quantization_tpu_torch.quant.sites import QuantSite

    sites = dict(model.named_modules())
    tensor_diff, tensor_n, chan_diff, chan_n = [], 0, [], 0
    per_tensor = [name for name in inputs if not sites[name].qcfg.per_channel]
    sampled = set(per_tensor[::HOST_SITE_STRIDE])
    for name, x in inputs.items():
        site: QuantSite = sites[name]
        pc = site.qcfg.per_channel
        if not pc and name not in sampled:
            continue
        if pc:
            x = x.narrow(site.channel_axis, 0, min(HOST_CHANNELS, x.shape[site.channel_axis]))
        c = x.shape[site.channel_axis] if pc else 1
        state = estimators.init(site.ecfg, site.qcfg, c, per_channel=pc)
        state, (_, maxval, mbits) = estimators.update(site.ecfg, site.qcfg, state, x.cpu(), pc,
                                                      site.channel_axis)
        if not pc:
            tensor_n += 1
            if (float(mbits[0]) != float(site.mantissa_bits[0])
                    or float(maxval[0]) != float(site.maxval[0].cpu())):
                tensor_diff.append(name)
            continue
        card = site.mses[:, :, :c].cpu()
        width = int(torch.round(site.mantissa_bits[0])) - 1 if card.shape[0] > 1 else 0
        votes = torch.argmin(state["mses"].amin(dim=1), dim=0)
        cand = torch.argmin(state["mses"][width], dim=0)
        differs = ((votes != torch.argmin(card.amin(dim=1), dim=0))
                   | (cand != torch.argmin(card[width], dim=0)))
        chan_n += c
        if bool(differs.any()):
            chan_diff.append((name, int(differs.sum())))
    return tensor_n, tensor_diff, chan_n, chan_diff


def check_mse_model(cli, dev, spec, counters):
    """Phase 5: ViT-B/16 at depth 2 calibrated with the MSE search (one
    batch), under FAST through the kernels (K1 and K2 at the elected widths)
    and their plain versions: every K2 call held to its contract and every
    K1 call to equality on its own inputs, the logits to ``RMS_LIMIT`` and
    the same top-1; and the sites' searches run again on the host from the
    inputs they saw on the card (:func:`host_election`)."""
    from fp8_quantization_tpu_torch.quant.sites import FAST, FIXED, QuantSite

    inputs, hooks = {}, []

    def record(name):
        def hook(site, args, kwargs):
            qp = args[1] if len(args) > 1 else kwargs.get("qp", FIXED)
            if qp.estimating:
                inputs[name] = args[0].detach().float().clone()
        return hook

    from fp8_quantization_tpu_torch.models import vit as vit_mod
    build = vit_mod.QuantizedViT

    def capture(*args, **kw):
        m = build(*args, **kw)
        for name, site in m.named_modules():
            if isinstance(site, QuantSite):
                hooks.append(site.register_forward_pre_hook(record(name), with_kwargs=True))
        return m

    vit_mod.QuantizedViT = capture
    try:
        model, qc, xt = calibrated_model(cli, MSE_FLAGS, dev, spec)
    finally:
        vit_mod.QuantizedViT = build
        for h in hooks:
            h.remove()
    report = site_report(model)

    def forward():
        with torch.no_grad():
            return model(xt, FAST).float()

    zero_counts(counters)
    with verified_gemms({}) as calls, verified_attention({}) as held:
        logits = forward()
    counts = read_counts(counters)
    with plain_kernels():
        plain = forward()
    rms_ok, rms_line = rms_verdict(rel_rms(logits, plain), forward, plain)
    same = bool((logits.argmax(-1) == plain.argmax(-1)).all())
    t0 = time.perf_counter()
    tensor_n, tensor_diff, chan_n, chan_diff = host_election(model, inputs)
    host_s = time.perf_counter() - t0
    dense = 6 * spec.num_layers + 1
    ok = (counts["K2"] == dense and counts["K1"] > 0 and calls["calls"] == dense
          and held["K1"] == counts["K1"] and read_counts(counters) == counts and same
          and rms_ok and bool(torch.isfinite(logits).all()) and not report["bad_maxval"])
    phase("model", f"ViT-B/16 MSE FAST, depth {spec.num_layers}, batch 1: elected widths weight "
                   f"{report['weight_widths']}, act/res {report['act_widths']}; {calls['calls']} "
                   f"K2 calls (routes {sorted(calls['routes'])}) within contract (min equal "
                   f"fraction {calls['min_equal']:.4f}), {held['K1']} K1 calls equal; "
                   f"{rms_line}, same top-1 {same}, launches {counts}; the host's search from "
                   f"the card's inputs ({host_s:.1f} s): {len(tensor_diff)} of {tensor_n} "
                   f"sampled per-tensor sites elect another width or maxval {tensor_diff}, "
                   f"{sum(n for _, n in chan_diff)} of {chan_n} sampled weight channels another "
                   f"vote or candidate {chan_diff}; ok={ok}")
    if not ok:
        raise SystemExit("ViT MSE FAST: kernels and plain versions disagree")
    return {"tensor_sites": tensor_n, "tensor_diff": len(tensor_diff), "channels": chan_n,
            "channel_diff": sum(n for _, n in chan_diff)}


def prefix_prompts(spec):
    """The prefix runs' prompts: one seeded 256-token head and a unique
    seeded tail each, of ``PREFIX_TAILS`` tokens."""
    rng = np.random.default_rng(21)
    shared = rng.integers(0, spec.vocab_size, PREFIX_SHARED).tolist()
    return [shared + rng.integers(0, spec.vocab_size, n).tolist() for n in PREFIX_TAILS]


def llama32_1b_spec():
    """Llama-3.2-1B's widths, the public draft for Llama-3-8B (it shares the
    vocabulary): Hugging Face ``meta-llama/Llama-3.2-1B`` ``config.json``,
    hidden 2048, 16 layers, 32 heads, 8 KV heads, MLP 8192, vocab 128256,
    rope theta 500000, RMS eps 1e-5. The published model ties ``lm_head``
    to the embedding and scales RoPE (``llama3``, factor 32); the port's
    Llama has an untied ``lm_head`` and plain RoPE. Its weights here are
    random from a seed: the repository holds none."""
    from fp8_quantization_tpu_torch.models.llama import LlamaSpec

    return LlamaSpec(vocab_size=128256, hidden_size=2048, num_layers=16, num_heads=32,
                     num_kv_heads=8, mlp_dim=8192, rope_theta=500000.0, rms_eps=1e-5,
                     max_seq_len=LLAMA_MAX_SEQ)


def serve_recorded(batcher, prompts, new_tokens):
    """Admit every prompt (one slot each), then step to completion,
    recording every call of the target. Returns, per prompt in order: its
    tokens, the f32 logit row behind each token (its admission's last real
    row, then the step or verify rows that emitted the rest), its
    admission's logit rows at the positions it prefilled and that
    admission's prefix length; and the wall seconds of each admission, of
    the steps, and (with a draft) of the draft decodes and the verifies
    (each synced), the steps' count and their (slot, round) count."""
    target, draft = batcher.model, batcher.draft
    stepping = [False]
    admissions, step_logits = [], []
    rec = {"admit_s": [], "step_s": 0.0, "draft_s": 0.0, "verify_s": 0.0}

    def synced(key, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        rec[key] += time.perf_counter() - t0
        return out

    def target_call(tokens, cache, qp, chunk_attention=False):
        if stepping[0]:
            kw = dict(chunk_attention=chunk_attention)
            logits, cache = (synced("verify_s", target, tokens, cache, qp, **kw) if draft
                             else target(tokens, cache, qp, **kw))
            step_logits.append(logits)
            return logits, cache
        lp = int(cache.length[0])
        logits, cache = target(tokens, cache, qp, chunk_attention=chunk_attention)
        admissions.append((lp, logits))
        return logits, cache

    def draft_call(tokens, cache, qp, chunk_attention=False):
        if stepping[0]:
            return synced("draft_s", draft, tokens, cache, qp, chunk_attention=chunk_attention)
        return draft(tokens, cache, qp, chunk_attention=chunk_attention)

    batcher.model = target_call
    if draft is not None:
        batcher.draft = draft_call
    slots = []
    for prompt in prompts:
        t0 = time.perf_counter()
        slots.append(batcher.admit(prompt, max_new_tokens=new_tokens))    # reads a token: syncs
        rec["admit_s"].append(time.perf_counter() - t0)
    rows = {s: [a[1][0, len(p) - a[0] - 1].float()] for s, p, a in zip(slots, prompts, admissions)}
    stepping[0] = True
    rec["steps"] = rec["slot_rounds"] = 0
    while True:
        before = {s: len(st["generated"]) for s, st in batcher.active.items()}
        t0 = time.perf_counter()
        out = batcher.step()                                               # reads tokens: syncs
        if not out:
            break
        rec["step_s"] += time.perf_counter() - t0
        rec["steps"] += 1
        rec["slot_rounds"] += len(out)
        for s in out:
            n = len(batcher.active[s]["generated"]) - before[s]
            rows[s].extend(step_logits[-1][s, :n].float())
    batcher.model, batcher.draft = target, draft
    rec["tokens"] = [batcher.retire(s) for s in slots]
    rec["rows"] = [rows[s] for s in slots]
    rec["prefilled"] = [(lp, logits[0, :len(p) - lp].float())
                        for p, (lp, logits) in zip(prompts, admissions)]
    return rec


def rows_verdict(toks, ref_toks, rows, ref_rows, extra=()):
    """Holds a run's tokens and the logit rows behind them against a
    reference run's of the same prompts, where a legal summation order
    separates the two: the rows compared are those whose context the runs
    share (each prompt's rows up to its first differing token, and the
    (ours, ref) pairs in ``extra``). Returns a record: their max |d|, their
    relative RMS (held to ``RMS_LIMIT``, which phase 5 brackets between a
    legal order and a lower-precision control), whether they are bit-equal,
    the argmax equal where the reference's top-1/top-2 margin is at least
    twice the max |d|, and ``tokens_agree_while_decided`` at that max |d|."""
    ours, ref = [a for a, _ in extra], [b for _, b in extra]
    for t, rt, r, rr in zip(toks, ref_toks, rows, ref_rows):
        n = next((i for i, (a, b) in enumerate(zip(t, rt)) if a != b), min(len(t), len(rt)))
        upto = min(n + 1, len(r), len(rr))
        ours.append(torch.stack(r[:upto]))
        ref.append(torch.stack(rr[:upto]))
    ours, ref = torch.cat([o.reshape(-1, o.shape[-1]) for o in ours]), \
        torch.cat([o.reshape(-1, o.shape[-1]) for o in ref])
    diff = float((ours - ref).abs().max())
    top2 = torch.topk(ref, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) >= 2 * diff
    margins = [[top2_margin(x) for x in rr] for rr in ref_rows]
    agree, compared = tokens_agree_while_decided(toks, ref_toks, margins, diff)
    rms = rel_rms(ours, ref)
    return dict(rows=ours.shape[0], max_diff=diff, rms=rms, equal=bool(torch.equal(ours, ref)),
                argmax=bool(((ours.argmax(-1) == ref.argmax(-1)) | ~decided).all()),
                decided=int(decided.sum()), agree=agree, compared=compared,
                finite=bool(torch.isfinite(ours).all()),
                ok=(agree and rms <= RMS_LIMIT and bool(torch.isfinite(ours).all())
                    and bool(((ours.argmax(-1) == ref.argmax(-1)) | ~decided).all())))


def verdict_line(v):
    return (f"{v['rows']} logit rows max|d| {v['max_diff']:.3g}, relative RMS {v['rms']:.4g} "
            f"(limit {RMS_LIMIT}), bit-equal {v['equal']}, argmax equal where decided "
            f"{v['argmax']} ({v['decided']} decided), tokens agree while decided {v['agree']} "
            f"(compared {v['compared']})")


def paged_batcher(model, spec, qp, **kw):
    """The paged runs' ``PagedBatcher``: the dense runs' slots and
    ``max_seq`` over ``LLAMA_PAGES`` pages of ``LLAMA_PAGE`` tokens."""
    from fp8_quantization_tpu_torch.models.paged_kv import PagedBatcher

    return PagedBatcher(model, spec, slots=LLAMA_SLOTS, num_pages=LLAMA_PAGES,
                        page_size=LLAMA_PAGE, max_seq=LLAMA_MAX_SEQ, qp=qp, **kw)


def serve_prefix(name, model, spec, qp, counters, dev, per_forward, paged=False):
    """Phase 4: the four ``prefix_prompts`` served cold, then through a
    ``PrefixCache``, 4 slots, ``PREFIX_NEW_TOKENS`` greedy tokens each; the
    first admission misses and the other three splice its 256-token prefix
    (``paged``: scatter it into fresh pages) and prefill only their tails
    over the slab or the gathered view (K7 with offsets). The warm run's
    launches, zeroed just before it, must be the counts its shapes imply (no
    K6 when ``paged``); its tokens and its warm rows are held to the cold
    run's by ``rows_verdict``, and when ``paged`` equal to them bit for bit.
    Returns the warm run's record."""
    from fp8_quantization_tpu_torch.models.prefix_cache import PrefixCache
    from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher

    prompts = prefix_prompts(spec)

    def batcher(**kw):
        if paged:
            return paged_batcher(model, spec, qp, **kw)
        return ContinuousBatcher(model, spec, slots=LLAMA_SLOTS, max_seq=LLAMA_MAX_SEQ, qp=qp,
                                 **kw)

    cold = serve_recorded(batcher(), prompts, PREFIX_NEW_TOKENS)
    pc = PrefixCache()
    torch.cuda.synchronize()
    zero_counts(counters)
    warm = serve_recorded(batcher(prefix_cache=pc), prompts, PREFIX_NEW_TOKENS)
    counts = read_counts(counters)
    forwards = len(prompts) + warm["steps"]
    expected = expected_counts(counters, per_forward, forwards,
                               k6=0 if paged else spec.num_layers * warm["steps"],
                               k7=spec.num_layers * len(prompts))
    # the warm admissions' rows at their tails against the cold rows at the
    # same positions
    extra = [(w, c[lp:]) for (lp, w), (_, c) in zip(warm["prefilled"], cold["prefilled"])
             if lp > 0]
    v = rows_verdict(warm["tokens"], cold["tokens"], warm["rows"], cold["rows"], extra)
    lps = [lp for lp, _ in warm["prefilled"]]
    ok = (v["ok"] and counts == expected and (pc.misses, pc.hits) == (1, 3)
          and lps == [0] + [PREFIX_SHARED] * 3
          and all(len(t) == PREFIX_NEW_TOKENS for t in warm["tokens"])
          and (not paged or (v["equal"] and warm["tokens"] == cold["tokens"])))
    warm["counts"], warm["verdict"] = counts, v
    name = f"{name}, paged" if paged else name
    phase("main", f"Llama-3-8B {name} with a PrefixCache: {len(prompts)} prompts of "
                  f"{PREFIX_SHARED} shared + {list(PREFIX_TAILS)} tokens, {pc.misses} miss and "
                  f"{pc.hits} hits (prefix lengths {lps}); admission ms cold "
                  f"{[round(1e3 * t, 2) for t in cold['admit_s']]}, warm "
                  f"{[round(1e3 * t, 2) for t in warm['admit_s']]}; warm against cold: "
                  f"{verdict_line(v)}; {warm['steps']} steps; launches {counts} (expected "
                  f"{expected}); {card_power()}; ok={ok}")
    if not ok:
        raise SystemExit(f"Llama {name} prefix run: wrong hits, launch counts or outputs")
    return warm


@contextlib.contextmanager
def verify_route():
    """Decode attention through K7 (one query row over the slab, with the
    slot's length as its offset) in place of K6: the route a speculative
    verify takes, on a bf16 cache."""
    from fp8_quantization_tpu_torch.ops.cuda import attention as k7
    from fp8_quantization_tpu_torch.ops.cuda import decode_attention as k6

    def through_k7(q, k_slab, v_slab, lengths, **kw):
        if kw.get("k_bias") is not None:
            raise ValueError("the verify route's reference runs on a bf16 cache")
        return k7.fused_sdpa(q[:, None].to(torch.bfloat16), k_slab, v_slab, causal=True,
                             offsets=lengths - 1)[:, 0]

    saved = k6.decode_attention
    k6.decode_attention = through_k7
    try:
        yield
    finally:
        k6.decode_attention = saved


@contextlib.contextmanager
def einsum_route():
    """Dense decode attention through ``models/llama.py::einsum_attention``
    over the whole decoded slab in place of K6: the route a paged decode
    takes over its gathered view (the JAX package's dispatch), on a bf16 or
    a coded cache. With the same prompts a dense run then computes what a
    paged run does, bit for bit: the same shapes (S = ``max_seq`` = pages x
    page size) and the same values below each length; keys past it get
    probability 0 whatever finite value they hold."""
    from fp8_quantization_tpu_torch.models.llama import einsum_attention
    from fp8_quantization_tpu_torch.numerics.codec import unpack_consts, unpack_exmy_bits
    from fp8_quantization_tpu_torch.ops.cuda import decode_attention as k6

    def through_einsum(q, k_slab, v_slab, lengths, k_bias=None, v_bias=None, kv_expo=None,
                       kv_mant=None):
        def load(u, bias):
            if bias is None:
                return u.to(torch.float32)
            eb, ss = unpack_consts(bias, kv_mant)
            return unpack_exmy_bits(u, kv_expo, kv_mant, eb, ss)

        b, h, d = q.shape
        hk = k_slab.shape[2]
        length = lengths - 1
        ctx = einsum_attention(q.reshape(b, 1, hk, h // hk, d), load(k_slab, k_bias),
                               load(v_slab, v_bias), length[:, None], length)
        return ctx.reshape(b, h, d)

    saved = k6.decode_attention
    k6.decode_attention = through_einsum
    try:
        yield
    finally:
        k6.decode_attention = saved


def rows_equal(rows, ref_rows):
    """Each request's logit rows equal the reference's bit for bit."""
    return len(rows) == len(ref_rows) and all(
        len(r) == len(rr) and all(torch.equal(a, b) for a, b in zip(r, rr))
        for r, rr in zip(rows, ref_rows))


def serve_paged(name, model, spec, qp, counters, dev, per_forward, plain):
    """Phase 4: ``serve_llama``'s prompts and schedule through a
    ``PagedBatcher`` (``paged_batcher``; its decodes take the einsum over
    each slot's gathered pages, no K6), held bit for bit, tokens and every
    logit row, to a dense run of the same prompts under ``einsum_route``
    (each run's launches the counts its shapes imply). The late prompt must
    reuse pages of the slot retired before it, and the paged run's peak
    memory must lie below the dense one's. Prints the median step of both
    beside the plain dense run's (``plain``, K6), the peak memory of each,
    the pages in use at the peak and the device ms a step of the gather
    (``aten::index``: each layer's K and V views and the embedding) and the
    scatter (``aten::index_put_``) from ``torch.profiler``. Returns the
    paged run and the dense one."""
    with einsum_route():
        dense = serve_llama(f"{name}, dense through the einsum route", model, spec, qp,
                            counters, dev, per_forward, k6=False, record=True)
    run = serve_llama(f"{name}, paged", model, spec, qp, counters, dev, per_forward,
                      batcher=paged_batcher(model, spec, qp), k6=False, record=True)
    ops = profile_decode(f"{name}, paged", model, spec, qp, dev,
                         batcher=paged_batcher(model, spec, qp),
                         ops=("aten::index", "aten::index_put_"))
    exact = run["tokens"] == dense["tokens"] and rows_equal(run["rows"], dense["rows"])
    rows = sum(len(r) for r in run["rows"])
    run.update(exact=exact, gather_ms=ops["aten::index"], scatter_ms=ops["aten::index_put_"],
               dense_step_ms=dense["step_ms_median"], dense_peak_gb=dense["peak_gb"])
    ok = (exact and bool(run["late_reused"]) and run["peak_gb"] < dense["peak_gb"]
          and all(torch.isfinite(r).all() for rr in run["rows"] for r in rr))
    phase("main", f"Llama-3-8B {name} paged against dense through the einsum route: tokens and "
                  f"{rows} logit rows equal bit for bit {exact}; median step paged "
                  f"{run['step_ms_median']:.2f} ms, dense einsum {dense['step_ms_median']:.2f} "
                  f"ms, dense K6 {plain['step_ms_median']:.2f} ms; peak memory paged "
                  f"{run['peak_gb']:.3f} GB, dense einsum {dense['peak_gb']:.3f} GB, dense K6 "
                  f"{plain['peak_gb']:.3f} GB; {run['peak_pages']} of {LLAMA_PAGES - 1} pages "
                  f"in use at the peak; the late prompt reused freed pages "
                  f"{run['late_reused']}; gather {run['gather_ms']:.3f} and scatter "
                  f"{run['scatter_ms']:.3f} device ms a step; {card_power()}; ok={ok}")
    if not ok:
        raise SystemExit(f"Llama {name} paged: not equal to the dense einsum run, no page "
                         "reuse or no memory saved")
    return run, dense


def run_paged_speculative(model, spec, dev, counters, dense):
    """Phase 4: ``run_speculative``'s self-draft run (FAST+fused, k = 4, the
    first four prompts) through a ``PagedBatcher`` with a ``PrefixCache``
    that a paged batcher filled by admitting each prompt once (entries of
    at most 64 tokens, bucket 32): the three prompts it holds 64 tokens of
    are admitted warm (their pages scatter the prefix, the remainder of at
    least 36 rows prefills over the gathered view: K7 with offsets, K2
    route B), the 17-token one cold (shorter than a bucket). The draft
    keeps its dense slab and prefills every prompt whole. Tokens and logit
    rows must equal the dense speculative run's (``dense``) bit for bit,
    and so its acceptance: the verify reads the same 2048 positions through
    the page table, and warm rows equal cold ones. Launches as the shapes
    imply."""
    from fp8_quantization_tpu_torch.models.prefix_cache import PrefixCache

    qp = serving_phase(False)
    prompts = llama_prompts(spec)[:LLAMA_SLOTS]
    prefix_cache = PrefixCache(bucket=32, max_entry_tokens=64)
    primer = paged_batcher(model, spec, qp, prefix_cache=prefix_cache)
    for prompt in prompts:
        primer.retire(primer.admit(prompt, max_new_tokens=1))
    del primer
    b = paged_batcher(model, spec, qp, prefix_cache=prefix_cache, draft_model=model,
                      draft_spec=spec, spec_k=SPEC_K)
    torch.cuda.synchronize()
    zero_counts(counters)
    run = serve_recorded(b, prompts, SPEC_NEW_TOKENS)
    counts = read_counts(counters)
    rounds, admissions = run["steps"], len(prompts)
    forwards = 2 * admissions + (SPEC_K + 2) * rounds
    expected = expected_counts(counters, {"K1": llama_k1_per_forward(spec),
                                          "K2": llama_dense_per_forward(spec)}, forwards,
                               k6=spec.num_layers * (SPEC_K + 1) * rounds,
                               k7=spec.num_layers * (2 * admissions + rounds))
    lps = [lp for lp, _ in run["prefilled"]]
    exact = run["tokens"] == dense["tokens"] and rows_equal(run["rows"], dense["rows"])
    run.update(counts=counts, exact=exact, acceptance=b.acceptance_rate,
               verdict=dense["verdict"],
               tokens_per_slot_round=sum(len(t) - 1 for t in run["tokens"])
               / max(run["slot_rounds"], 1))
    ok = (exact and counts == expected and lps == [0, 64, 64, 64]
          and prefix_cache.hits == 3 and b.acceptance_rate == dense["acceptance"]
          and b.allocator.num_free == LLAMA_PAGES - 1)
    phase("main", f"Llama-3-8B FAST+fused paged speculative, self-draft, k={SPEC_K}, "
                  f"admissions warm at prefix lengths {lps}: acceptance "
                  f"{b.acceptance_rate:.4f} ({b.accepted} of {b.proposed}; dense "
                  f"{dense['acceptance']:.4f}), {run['tokens_per_slot_round']:.3f} tokens a slot a "
                  f"round over {rounds} rounds, a round {1e3 * run['step_s'] / rounds:.2f} ms "
                  f"wall (draft decodes {1e3 * run['draft_s'] / rounds:.2f}, verify "
                  f"{1e3 * run['verify_s'] / rounds:.2f}); tokens and rows equal to the dense "
                  f"speculative run bit for bit {exact}; launches {counts} (expected "
                  f"{expected}); {card_power()}; ok={ok}")
    if not ok:
        raise SystemExit("Llama paged speculative: not equal to the dense run, or wrong counts")
    return run


def run_speculative(model, spec, dev, counters):
    """Phase 4: greedy speculative serving under FAST+fused, ``SPEC_K`` = 4,
    4 slots, the first four prompts, ``SPEC_NEW_TOKENS`` each, with a
    self-draft and with a draft at Llama-3.2-1B's widths (seeded weights,
    calibrated as the target). Greedy speculation emits the target's own
    greedy decode as its verify computes it: the verify runs K7 with
    offsets and K2 route B (20 rows), whose rows do not depend on the other
    rows of the call. So each run's tokens and the logit rows behind them
    must equal, bit for bit, a non-speculative run of the same prompts
    whose decode steps take that route (17 slots, so K2 takes route B; K7
    in place of K6: ``verify_route``), whatever the draft; and each run's
    launches, zeroed just before it, the counts its shapes imply. Against
    the plain FAST run (K6 and K2 route A, another legal order) the rows
    and tokens are read by ``rows_verdict`` and printed: the two orders
    part within a few tokens at full depth on random weights, so a
    self-draft's acceptance falls below 1. Prints acceptance, tokens a slot
    a round, the round's wall ms split into the draft decodes and the
    verify, and the peak memory with the draft beside the target."""
    from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher
    from fp8_quantization_tpu_torch.ops.cuda.fused_matmul import ROUTE_A_MAX_M

    qp = serving_phase(False)
    prompts = llama_prompts(spec)[:LLAMA_SLOTS]

    def batcher(slots=LLAMA_SLOTS, **kw):
        return ContinuousBatcher(model, spec, slots=slots, max_seq=LLAMA_MAX_SEQ, qp=qp, **kw)

    plain = serve_recorded(batcher(), prompts, SPEC_NEW_TOKENS)
    with verify_route():
        reference = serve_recorded(batcher(slots=ROUTE_A_MAX_M + 1), prompts, SPEC_NEW_TOKENS)
    v = rows_verdict(reference["tokens"], plain["tokens"], reference["rows"], plain["rows"])
    phase("main", f"Llama-3-8B FAST+fused, plain decode through the verify's route (K7, K2 "
                  f"route B) against the plain route (K6, route A), {len(prompts)} prompts, "
                  f"{SPEC_NEW_TOKENS} tokens: {verdict_line(v)} (printed, not held: at full "
                  f"depth the two legal orders part within a few tokens); {card_power()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    small = llama32_1b_spec()
    small_model = calibrated_llama(small, dev, seed=2)
    torch.cuda.synchronize()
    phase("main", f"Llama-3.2-1B-width draft: "
                  f"{sum(p.numel() for p in small_model.parameters()) / 1e9:.3f} B parameters, "
                  f"built and calibrated in {time.perf_counter() - t0:.1f} s beside the target, "
                  f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    out = {}
    for name, draft, draft_spec in (("self-draft", model, spec),
                                    ("Llama-3.2-1B-width draft", small_model, small)):
        b = batcher(draft_model=draft, draft_spec=draft_spec, spec_k=SPEC_K)
        torch.cuda.synchronize()
        zero_counts(counters)
        run = serve_recorded(b, prompts, SPEC_NEW_TOKENS)
        counts = read_counts(counters)
        rounds, admissions = run["steps"], len(prompts)
        per = {}
        for s, forwards in ((spec, admissions + rounds),
                            (draft_spec, admissions + (SPEC_K + 1) * rounds)):
            for key, n in (("K1", llama_k1_per_forward(s)), ("K2", llama_dense_per_forward(s))):
                per[key] = per.get(key, 0) + n * forwards
        expected = expected_counts(counters, per, 1,
                                   k6=draft_spec.num_layers * (SPEC_K + 1) * rounds,
                                   k7=spec.num_layers * (admissions + rounds)
                                   + draft_spec.num_layers * admissions)
        exact = (run["tokens"] == reference["tokens"]
                 and rows_equal(run["rows"], reference["rows"]))
        emitted = sum(len(t) - 1 for t in run["tokens"])
        run.update(counts=counts, verdict=v, exact=exact, acceptance=b.acceptance_rate,
                   tokens_per_slot_round=emitted / max(run["slot_rounds"], 1),
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        ok = (exact and counts == expected and v["finite"]
              and all(len(t) == SPEC_NEW_TOKENS for t in run["tokens"]))
        # equal to the reference, so its reading against the plain run is this run's
        phase("main", f"Llama-3-8B FAST+fused speculative, {name}, k={SPEC_K}: acceptance "
                      f"{b.acceptance_rate:.4f} ({b.accepted} of {b.proposed}), "
                      f"{run['tokens_per_slot_round']:.3f} tokens a slot a round over {rounds} "
                      f"rounds; a round {1e3 * run['step_s'] / rounds:.2f} ms wall, of it draft "
                      f"decodes {1e3 * run['draft_s'] / rounds:.2f} ms and the verify "
                      f"{1e3 * run['verify_s'] / rounds:.2f} ms (synced); plain FAST steps "
                      f"{1e3 * plain['step_s'] / plain['steps']:.2f} ms a token; tokens and "
                      f"rows equal to the verify-route reference bit for bit {exact}; peak "
                      f"memory {run['peak_gb']:.2f} GB; "
                      f"launches {counts} (expected {expected}); {card_power()}; ok={ok}")
        if not ok:
            raise SystemExit(f"Llama speculative {name}: wrong launch counts or outputs")
        out[name] = run
    del small_model
    torch.cuda.empty_cache()
    return out


def check_warm_and_verify(model, spec, qp, dense, counters):
    """Phase 5: one warm admission and one speculative verify at depth 2,
    every K1, K2/K4 and K7 call held on its own inputs
    (``verified_gemms``, ``verified_attention``) and the launches equal to
    the counts the shapes imply. A self-draft and a ``PrefixCache``: the
    second prompt (96 tokens of the first and a 20-token tail) splices the
    first's 96-token prefix and prefills 32 padded rows over the slab (K7
    with offsets, K2/K4 route B); one round of 4 slots is five draft decodes
    (K6, route A) and a 20-row verify (K7 with offsets, route B)."""
    from fp8_quantization_tpu_torch.models.prefix_cache import PrefixCache
    from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher

    first = llama_prompts(spec)[1]
    second = first[:96] + np.random.default_rng(22).integers(0, spec.vocab_size, 20).tolist()
    pc = PrefixCache()
    batcher = ContinuousBatcher(model, spec, slots=LLAMA_SLOTS, max_seq=LLAMA_MAX_SEQ, qp=qp,
                                prefix_cache=pc, draft_model=model, draft_spec=spec,
                                spec_k=SPEC_K)
    zero_counts(counters)
    with verified_gemms({}) as calls, verified_attention({}) as held:
        batcher.admit(first, max_new_tokens=8)
        batcher.admit(second, max_new_tokens=8)
        emitted = batcher.step()
    counts = read_counts(counters)
    forwards = 4 + SPEC_K + 1 + 1
    expected = expected_counts(counters, {"K1": llama_k1_per_forward(spec),
                                          dense: llama_dense_per_forward(spec)}, forwards,
                               k6=spec.num_layers * (SPEC_K + 1), k7=spec.num_layers * 5)
    ok = (counts == expected and (pc.misses, pc.hits) == (1, 1) and len(emitted) == 2
          and calls["calls"] == counts[dense] and calls["routes"] == {"A", "B"}
          and held["K7"] == counts["K7"] and held["K1"] == counts["K1"])
    phase("model", f"Llama-3-8B width {spec.hidden_size}, depth {spec.num_layers}, "
                   f"{'PACKED+packed_kv' if dense == 'K4' else 'FAST'}+fused: one warm admission "
                   f"(prefix 96, tail 20) and one verify ({LLAMA_SLOTS} slots x {SPEC_K + 1} "
                   f"tokens): {calls['calls']} {dense} calls (routes {sorted(calls['routes'])}, "
                   f"min equal fraction {calls['min_equal']:.4f}) and {held['K7']} K7 calls "
                   f"(min equal fraction {held['min_equal']:.4f}, worst |d| / bound "
                   f"{held['worst_ratio']:.3g}) within their contract, {held['K1']} K1 calls "
                   f"equal; launches {counts} (expected {expected}); ok={ok}")
    if not ok:
        raise SystemExit("Llama depth 2 warm admission and verify: wrong calls or counts")


def run_llama_serving(dev, counters):
    """Phase 4 for Llama-3-8B: one model, calibrated once; the FAST run on a
    bf16 cache, its prefix run and its speculative runs, the paged FAST runs
    (plain, prefix, speculative), then packing and stripping in place and
    the PACKED run, prefix run and paged run on a uint8 cache of the same
    calibrated sites; the mesh: a ring prefill before packing, and after it
    the PACKED prompts over a virtual (2, 4) mesh against a recorded run
    without one. Returns the spec, the plain runs, the prefix and
    speculative runs, the paged runs with their dense references and the
    mesh runs."""
    from fp8_quantization_tpu_torch.models.llama import LLAMA3_8B
    from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher, pack_llama

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
    more = {"fast prefix": serve_prefix("FAST+fused, bf16 KV", model, spec, serving_phase(False),
                                        counters, dev, {"K1": k1, "K2": dense})}
    more.update({f"spec {name}": run for name, run in
                 run_speculative(model, spec, dev, counters).items()})
    paged = {}
    paged["paged FAST"], paged["dense einsum FAST"] = serve_paged(
        "FAST+fused", model, spec, serving_phase(False), counters, dev,
        {"K1": k1, "K2": dense}, runs["fast"])
    paged["paged FAST prefix"] = serve_prefix("FAST+fused, bf16 KV", model, spec,
                                              serving_phase(False), counters, dev,
                                              {"K1": k1, "K2": dense}, paged=True)
    paged["paged spec self-draft"] = run_paged_speculative(model, spec, dev, counters,
                                                           more["spec self-draft"])
    mesh = {"ring prefill": check_ring_prefill(model, spec, dev)}
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
    more["packed prefix"] = serve_prefix("PACKED+packed_kv+fused, uint8 KV", model, spec,
                                         serving_phase(True), counters, dev,
                                         {"K1": k1, "K4": dense})
    paged["paged PACKED"], paged["dense einsum PACKED"] = serve_paged(
        "PACKED+packed_kv+fused", model, spec, serving_phase(True), counters, dev,
        {"K1": k1, "K4": dense}, runs["packed"])
    # the mesh: the same prompts for MESH_NEW_TOKENS tokens, recorded without
    # a mesh (the first tokens of the PACKED run) and over a virtual (2, 4) mesh
    reference = serve_llama("PACKED+packed_kv+fused, uint8 KV, recorded", model, spec,
                            serving_phase(True), counters, dev, {"K1": k1, "K4": dense},
                            record=True, new_tokens=MESH_NEW_TOKENS)
    if reference["tokens"] != [t[:MESH_NEW_TOKENS] for t in runs["packed"]["tokens"]]:
        raise SystemExit("Llama PACKED: a shorter run gives other first tokens")
    mesh["mesh PACKED"] = serve_mesh("PACKED+packed_kv+fused, uint8 KV", model, spec,
                                     serving_phase(True), counters, dev,
                                     {"K1": k1, "K4": dense}, virtual_mesh(dev, 2, 4), reference)
    profile_decode("PACKED+packed_kv+fused over a virtual (2, 4) mesh", model, spec,
                   serving_phase(True), dev, batcher=ContinuousBatcher(
                       model, spec, slots=LLAMA_SLOTS, max_seq=LLAMA_MAX_SEQ,
                       qp=serving_phase(True), mesh=virtual_mesh(dev, 2, 4)))
    del model
    torch.cuda.empty_cache()
    return spec, runs, more, paged, mesh


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
    # K5 per cell of a virtual (1, 4) mesh: integer sums, so every token equal
    run["mesh"] = serve_mesh("w4a8 PACKED+fused, bf16 KV", model, spec, qp, counters, dev,
                             {"K5": llama_dense_per_forward(spec)}, virtual_mesh(dev, 1, 4), run)
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


# the plain-PyTorch paths a run counts, as (module of ops, function, key):
# the CNNs' oracle and int8 conv, the special run methods' products
CNN_COUNTED = (("layers", "approx_matmul_oracle", "oracle"),
               ("fastpath", "quantized_conv_int8", "int8_conv"))
SPECIAL_COUNTED = (("layers", "approx_matmul_oracle", "oracle"),
                   ("layers", "qama_matmul_2d", "qama"))


@contextlib.contextmanager
def counted_calls(record, counted=CNN_COUNTED):
    """Counts the calls of each function of ``counted`` in ``record[key]``:
    by default the grouped convs' oracle (``layers.approx_matmul_oracle``)
    and the int8 conv (``fastpath.quantized_conv_int8``); neither is a hand
    kernel with a counter of its own."""
    from fp8_quantization_tpu_torch.ops import fastpath, layers

    mods = {"layers": layers, "fastpath": fastpath}
    swaps = [(mods[mod], name, key) for mod, name, key in counted]
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


# ---------------------------------------------------------------------------
# Real weights and images, the demo and the surgery layers:
# validate-quantized-demo, a QuantizedSequential of every new layer kind,
# --model-dir (torch state dicts under the sources' names, and the port's
# checkpoints), --save-checkpoint-dir and --images-dir
DEMO_FLAGS = ["validate-quantized-demo" if f == "validate-quantized" else
              "demo_quantized" if f == "vit_quantized" else f for f in PUBLISHED_FLAGS]
DEMO_RUNS = {
    "published": DEMO_FLAGS,
    "approx": [{"--no-approx_flag": "--approx_flag"}.get(f, f) for f in DEMO_FLAGS]
    + ["--withComp", "--with_approx"],
    "fast": DEMO_FLAGS + ["--fast-mode"],
    "packed": DEMO_FLAGS + ["--fast-mode", "--packed-weights"],
}
# the demo's forwards: the init forward of a zeros input, one calibration
# batch and the two eval batches of --max-eval-batches 2
DEMO_EVALS = 2


def demo_expected(mode):
    """The demo's one ``QuantDense`` (10 -> 10) in a run: K3 in every
    forward under approx; K1 for its act and res sites and K2 in the eval
    forwards under ``--fast-mode``; under ``--packed-weights`` also in the
    weight-cache forward, and K4 in the eval forwards."""
    want = {name: 0 for name in ("K1", "K2", "K3", "K4", "K5", "K6", "K7")}
    if mode == "approx":
        want["K3"] = 2 + DEMO_EVALS
    elif mode == "fast":
        want["K1"], want["K2"] = 2 * DEMO_EVALS, DEMO_EVALS
    elif mode == "packed":
        want["K1"], want["K2"], want["K4"] = 2 + 2 * DEMO_EVALS, 1, DEMO_EVALS
    return want


def run_demo(cli, counters, mode):
    """``validate-quantized-demo`` in one mode with every count zeroed just
    before it, held to :func:`demo_expected`; then the same run through the
    plain versions: approx logits equal to K3's plain version's bit for
    bit, the serving modes' within ``RMS_LIMIT`` (M = 8 rows: K2 and K4 take
    route A, which sums as the plain versions do). Returns (out, ms/img,
    counts)."""
    zero_counts(counters)
    with captured_runs(cli, {}) as rec:
        out, ms = run_cli(cli, DEMO_RUNS[mode])
    counts = read_counts(counters)
    with plain_kernels(), captured_runs(cli, {}) as plain:
        run_cli(cli, DEMO_RUNS[mode])
    logits, ref = torch.cat(rec["logits"]), torch.cat(plain["logits"])
    rms, diff = rel_rms(logits, ref), float((logits - ref).abs().max())
    want = demo_expected(mode)
    ok = (counts == want and bool(torch.isfinite(logits).all())
          and (torch.equal(logits, ref) if mode in ("approx", "published") else rms <= RMS_LIMIT))
    phase("main", f"demo_quantized {mode}: {out['metrics']}, {ms:.3f} ms/img over "
                  f"{out['images']} images ({card_power()}), launches {counts} (expected {want}); "
                  f"logits against the plain run: max|d| {diff:.3g}, relative RMS {rms:.4g}, "
                  f"ok={ok}")
    if not ok:
        raise SystemExit(f"validate-quantized-demo {mode}: wrong launch counts or logits")
    return out, ms, counts


# The surgery model: a QuantizedSequential with each new layer kind on 1-D
# data (1024 positions of 64 channels, batch 16), then a tied
# QuantizedActWrapper around a second average pool, then a sequential head:
#   Conv 3 (-> QuantConv1d) + ReLU; ConvTranspose 3 / 2 with torch's padding
#   1 and output padding 1 (2048 positions) + ReLU; AvgPool 4 (its own
#   site: the input is quantized); tied wrapper: AvgPool 4 (128 positions);
#   Flatten; Linear 8192 -> 256 + BatchNorm + ReLU (-> BNQuantDense);
#   Linear 256 -> 1000
SURGERY_BATCH = 16
SURGERY_LENGTH, SURGERY_CH = 1024, 64
SURGERY_HIDDEN, SURGERY_CLASSES = 256, 1000
SURGERY_MODES = ("approx", "fast", "packed", "fp8 chained", "int8 packed", "int8 chained")
SURGERY_EVALS = 2


def surgery_specs():
    from fp8_quantization_tpu_torch.models import porting
    from fp8_quantization_tpu_torch.models import surgery as s

    body = (s.Conv(SURGERY_CH, (3,), (1,)), s.Act("relu"),
            s.ConvTranspose(SURGERY_CH, (3,), (2,),
                            porting.conv_transpose_padding_from_torch((3,), 2, 1, 1)),
            s.Act("relu"), s.AvgPool((4,)))
    head = (s.Flatten(), s.Linear(SURGERY_HIDDEN), s.BatchNorm(), s.Act("relu"),
            s.Linear(SURGERY_CLASSES))
    return body, head


class SurgeryNet(torch.nn.Module):
    """The sequential body, the tied pool wrapper and the sequential head."""

    def __init__(self, qc, generator):
        from fp8_quantization_tpu_torch.models.surgery import QuantizedSequential
        from fp8_quantization_tpu_torch.ops.layers import QuantizedActWrapper

        super().__init__()
        body, head = surgery_specs()
        kw = dict(generator=generator)
        self.body = QuantizedSequential(qc, body, (SURGERY_LENGTH, SURGERY_CH), **kw)
        self.pool = QuantizedActWrapper(
            qc, lambda x: torch.nn.functional.avg_pool1d(x.movedim(-1, 1), 4).movedim(1, -1),
            tie_input_output=True)
        length, ch = self.body.output_shape
        self.head = QuantizedSequential(qc, head, (length // 4, ch), **kw)
        with torch.no_grad():
            for m in self.modules():
                if hasattr(m, "var") and hasattr(m, "gamma"):
                    m.mean.normal_(0.0, 0.1, generator=generator)
                    m.var.uniform_(0.5, 1.5, generator=generator)

    def forward(self, x, qp):
        from fp8_quantization_tpu_torch.quant.sites import decoded

        return decoded(self.head(self.pool(self.body(x, qp), qp), qp))


def surgery_products(batch):
    """The model's products of one forward: ``(name, M, K, N)``, M the
    im2col rows at ``batch``."""
    length = SURGERY_LENGTH
    return [("conv1d 3", batch * length, 3 * SURGERY_CH, SURGERY_CH),
            ("convT 3/2", batch * 2 * length, 3 * SURGERY_CH, SURGERY_CH),
            ("linear+BN", batch, SURGERY_CH * 2 * length // 16, SURGERY_HIDDEN),
            ("linear", batch, SURGERY_HIDDEN, SURGERY_CLASSES)]


def surgery_expected(mode):
    """Each kernel's launches in a surgery run (one calibration and two
    eval forwards, as the driver makes them): approx, K3 for all four
    products in every forward; ``--fast-mode``, K1 for the act and res site
    of each layer (8), the body's pool site and the tied wrapper's two calls
    (11 a forward) and K2 for the two dense layers, in the eval forwards;
    packed, also in the weight-cache forward, with K4 for the dense layers
    in the eval forwards; FP8 chained as packed, less the act site that the
    BN layer's pending ``Affine`` feeds (10 a forward); the uniform runs
    launch none (two int8 conv calls an eval forward)."""
    want = {name: 0 for name in ("K1", "K2", "K3", "K4", "K5", "K6", "K7")}
    want["int8_conv"] = 0
    if mode == "approx":
        want["K3"] = 4 * (1 + SURGERY_EVALS)
    elif mode == "fast":
        want["K1"], want["K2"] = 11 * SURGERY_EVALS, 2 * SURGERY_EVALS
    elif mode in ("packed", "fp8 chained"):
        per = 10 if mode == "fp8 chained" else 11
        want["K1"], want["K2"], want["K4"] = 11 + per * SURGERY_EVALS, 2, 2 * SURGERY_EVALS
    else:
        want["int8_conv"] = 2 * SURGERY_EVALS
    return want


def surgery_qc(cli, mode):
    """The configuration and CLI flags of a mode, as the CNN runs take them."""
    flags = cnn_flags("mobilenet_v2_quantized", mode)
    return cli.config_from_args(cli.build_parser().parse_args(flags)), flags


def surgery_batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(SURGERY_BATCH, SURGERY_LENGTH, SURGERY_CH)).astype(np.float32),
             rng.integers(0, SURGERY_CLASSES, size=SURGERY_BATCH)) for _ in range(n)]


def run_surgery(cli, counters, dev, mode):
    """The surgery model through ``eval.driver.validate_quantized`` (one
    calibration and two eval batches), counts zeroed just before it and held
    to :func:`surgery_expected`; then the calibrated model's logits on the
    first eval batch held to its plain path: approx, FAST, PACKED and FP8
    CHAINED through the plain versions on the card, equal bit for bit (the
    approximate products sit on the result grid, so K3's sums are exact; the
    dense products have 16 rows, route A); the uniform runs against the same
    model and phase on the CPU within ``RMS_LIMIT`` (the integer sums are
    exact; BN's ``rsqrt`` is not correctly rounded on the card). Returns
    (metrics, ms/img, counts)."""
    from fp8_quantization_tpu_torch.eval import driver
    from fp8_quantization_tpu_torch.quant.sites import QuantPhase

    qc, flags = surgery_qc(cli, mode)
    fast, packed = "--fast-mode" in flags, "--packed-weights" in flags
    chained = "--chained-acts" in flags
    # drawn on the host from the seed, then moved, as the CLI builds models
    model = SurgeryNet(qc, torch.Generator().manual_seed(14)).to(dev)
    calib, evals = surgery_batches(1, 20), surgery_batches(SURGERY_EVALS, 21)
    example = torch.zeros((1, SURGERY_LENGTH, SURGERY_CH), device=dev)
    zero_counts(counters)
    with counted_calls({}) as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, _ = driver.validate_quantized(model, calib, evals, fast=fast, packed=packed,
                                               chained=chained, qc=qc, calib_example=example)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = {**read_counts(counters), "int8_conv": calls["int8_conv"]}
    want = surgery_expected(mode)
    qp = QuantPhase(phase="fixed", fast=fast, packed=packed, chained=chained)
    x = torch.from_numpy(evals[0][0]).to(dev)
    with torch.no_grad():
        logits = model(x, qp).float()
        if mode.startswith("int8"):
            model.cpu()
            ref = model(x.cpu(), qp).float().to(dev)
            model.to(dev)
        else:
            with plain_kernels():
                ref = model(x, qp).float()
    rms, diff = rel_rms(logits, ref), float((logits - ref).abs().max())
    same = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    held = rms <= RMS_LIMIT if mode.startswith("int8") else torch.equal(logits, ref)
    ok = counts == want and bool(torch.isfinite(logits).all()) and held and \
        np.isfinite(metrics["loss"])
    ms = 1e3 * seconds / (SURGERY_BATCH * (1 + SURGERY_EVALS))
    phase("main", f"surgery model {mode} (Conv1d, ConvTranspose1d, pool sites, BNQuantDense, "
                  f"{SURGERY_BATCH}x{SURGERY_LENGTH}x{SURGERY_CH}): {metrics}, {ms:.3f} ms/img "
                  f"({card_power()}), launches {counts} (expected {want}); logits against "
                  f"{'the CPU' if mode.startswith('int8') else 'the plain versions'}: max|d| "
                  f"{diff:.3g}, relative RMS {rms:.4g}, top-1 agreement {same:.4f}, ok={ok}")
    if not ok:
        raise SystemExit(f"surgery model {mode}: wrong launch counts or logits")
    del model
    torch.cuda.empty_cache()
    return metrics, ms, counts


def check_k3_surgery(k3, dev, sm_clock_hz):
    """Phase 3, the surgery model's shapes: K3 at each distinct (K, N) of
    its products on a ``SLICE_ROWS`` row slice, bit for bit against its
    plain version (the flagship requantizes every product onto the result
    grid, so the sums are exact), then timed at every product of a
    batch-16 forward beside its bound (the largest of the bytes over HBM
    bandwidth, one table read a product and one f32 add a product).
    Returns (worst |d|, per-forward times)."""
    worst = 0.0
    shapes = sorted({(k, n) for _, _, k, n in surgery_products(1)})
    for k, n in shapes:
        a, b, bb = grid_operands(SLICE_ROWS, k, n, dev, seed=k + n + 14, on_device=True)
        ours = k3.approx_matmul(a, b, 5, bb, 5, **FLAGSHIP)
        plain = k3.approx_matmul_plain(a, b, 5, bb, 5, **FLAGSHIP)
        worst = max(worst, float((ours - plain).abs().max()))
        if not (torch.equal(ours, plain) and bool(torch.isfinite(ours).all())):
            raise SystemExit(f"K3 disagrees with its plain version at the surgery shape {k}x{n}")
    table_reads_per_s = (torch.cuda.get_device_properties(dev).multi_processor_count
                         * SHARED_WORDS_PER_SM_CLOCK * sm_clock_hz)
    totals = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "adds_ms": 0.0,
              "launches": 0}
    lines = []
    for name, m, k, n in surgery_products(SURGERY_BATCH):
        a, b, bb = grid_operands(m, k, n, dev, seed=m + k + n, on_device=True)
        ms = cuda_ms(lambda: k3.approx_matmul(a, b, 5, bb, 5, **FLAGSHIP), 3)
        plain_ms = cuda_ms(lambda: k3.approx_matmul_plain(a, b, 5, bb, 5, **FLAGSHIP), 1)
        bytes_ms = 1e3 * 4 * (m * k + k * n + m * n + n + 2) / HBM_BYTES_PER_S
        ops_ms = 1e3 * m * k * n / table_reads_per_s
        adds_ms = 1e3 * m * k * n / F32_ADDS_PER_S
        _add(totals, 1, ms=ms, plain_ms=plain_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
             adds_ms=adds_ms)
        totals["launches"] += 1
        lines.append(f"{name} {m}x{k}x{n} {ms:.4f} ms (plain {plain_ms:.3f}, bound "
                     f"{max(bytes_ms, ops_ms, adds_ms):.4f})")
        del a, b
    totals["bound_ms"] = max(totals["bytes_ms"], totals["ops_ms"], totals["adds_ms"])
    totals["bound_by"] = "bytes" if totals["bytes_ms"] == totals["bound_ms"] else "operations"
    phase("kernels", f"K3 at the surgery model's {len(shapes)} distinct (K, N) "
                     f"({', '.join(f'{k}x{n}' for k, n in shapes)}), {SLICE_ROWS}-row slices: "
                     f"equal to the plain version, max|d| {worst:.3g}; per batch-{SURGERY_BATCH} "
                     f"forward {totals['ms']:.3f} ms (plain {totals['plain_ms']:.3f}), bound "
                     f"{totals['bound_ms']:.4f} ms ({totals['bound_by']}; table reads "
                     f"{totals['ops_ms']:.4f}, f32 adds {totals['adds_ms']:.4f}); by shape: "
                     + "; ".join(lines))
    torch.cuda.empty_cache()
    return worst, totals


# K2 and K4 at the slice's dense shapes: the surgery model's two linears at
# its 16 rows (route A) and on a 64-row slice (route B), the demo's 10 x 10
# at its 8 rows
SURGERY_GEMM_SHAPES = ([(m, SURGERY_CH * 2 * SURGERY_LENGTH // 16, SURGERY_HIDDEN)
                        for m in (SURGERY_BATCH, SLICE_ROWS)]
                       + [(m, SURGERY_HIDDEN, SURGERY_CLASSES) for m in (SURGERY_BATCH, SLICE_ROWS)]
                       + [(BATCH, 10, 10)])


def check_int8_transpose(dev):
    """Phase 3, the int8 sums of a transposed conv (input dilation 2, torch's
    padding 1 and output padding 1) and of a 1-D conv on the card equal to
    the CPU's, with the zero point's code 0 and -128 filling the holes and
    the padding."""
    from fp8_quantization_tpu_torch.models.porting import conv_transpose_padding_from_torch
    from fp8_quantization_tpu_torch.ops.fastpath import int8_conv_sums

    gen = torch.Generator().manual_seed(41)
    x = torch.randint(-128, 128, (2, 256, SURGERY_CH), generator=gen, dtype=torch.int8)
    w = torch.randint(-128, 128, (3, SURGERY_CH, SURGERY_CH), generator=gen, dtype=torch.int8)
    cases = {"conv1d": dict(strides=(1,), padding="SAME", dilation=(1,)),
             "convT 3/2": dict(strides=(1,), dilation=(1,), input_dilation=(2,),
                               padding=conv_transpose_padding_from_torch((3,), 2, 1, 1))}
    for name, kw in cases.items():
        for cx in (0.0, -128.0):
            ours = int8_conv_sums(x.to(dev), w.to(dev), torch.tensor(cx, device=dev),
                                  with_xsum=True, **kw)
            cpu = int8_conv_sums(x, w, torch.tensor(cx), with_xsum=True, **kw)
            if not (torch.equal(ours[0].cpu(), cpu[0]) and torch.equal(ours[1].cpu(), cpu[1])):
                raise SystemExit(f"int8 {name} sums on the card differ from the CPU's, cx {cx}")
    phase("kernels", f"int8 sums of the surgery model's {' and '.join(cases)} (256 positions, "
                     f"{SURGERY_CH} channels, cx 0 and -128 in the holes and pads): equal to "
                     "the CPU int32 path")


# --model-dir: seeded FP32 state dicts under the sources' own names, each
# run on the flags of its earlier phase beside a run from the seeded init
MODEL_DIR_RUNS = (("vit_quantized", "published"), ("vit_quantized", "fast"),
                  ("resnet18_quantized", "published"), ("resnet50_quantized", "published"),
                  ("mobilenet_v2_quantized", "published"))
SOURCE_FILES = {"vit_quantized": "pytorch_model.bin", "resnet18_quantized": "resnet18.pth",
                "resnet50_quantized": "resnet50.pth",
                "mobilenet_v2_quantized": "mobilenet_v2.pth.tar"}


def model_dir_flags(arch, mode):
    if arch == "vit_quantized":
        return SERVING_FLAGS["fast"] if mode == "fast" else PUBLISHED_FLAGS
    return cnn_flags(arch, mode)


def model_dir_expected(arch, mode):
    if arch != "vit_quantized":
        return cnn_expected(arch, mode)
    want = {name: 0 for name in ("K1", "K2", "K3", "K4", "K5", "K6", "K7")}
    if mode == "fast":
        want["K1"], want["K2"] = K1_LAUNCHES_PER_FORWARD * 2, DENSE_LAUNCHES_PER_FORWARD * 2
    return want


def run_model_dir(cli, counters, tmp):
    """``validate-quantized --model-dir`` on each of ``MODEL_DIR_RUNS`` at
    full width: the file is a seeded FP32 state dict under the source's own
    names (HF ``ViTForImageClassification``, torchvision ResNet with its BN
    counters, the reference's MobileNetV2), written to ``tmp`` and deleted
    after. Checks (a) every tensor of the file but the BN counters was read,
    and every ported parameter and BN buffer of the run's model equals the
    file's tensor after its layout change; (b) the eval logits differ from
    a run of the same flags from the seeded init; (c) the launches equal
    the earlier phases' for the same flags, the metrics finite. Prints the
    file's write, load and porting seconds and each run's ms/img. Returns
    {run: {...}}."""
    import os

    from fp8_quantization_tpu_torch.models import porting

    out = {}
    for arch in dict.fromkeys(a for a, _ in MODEL_DIR_RUNS):
        path = os.path.join(tmp, SOURCE_FILES[arch])
        t0 = time.perf_counter()
        state = porting.seeded_source_state(arch, torch.Generator().manual_seed(7))
        torch.save(state, path)
        t1 = time.perf_counter()
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        t2 = time.perf_counter()
        used = porting.UsedKeys(loaded)
        ported = porting.port_architecture(arch, used)
        t3 = time.perf_counter()
        unused = porting.unported_keys(used)
        mb = os.path.getsize(path) / 2 ** 20
        for a, mode in MODEL_DIR_RUNS:
            if a != arch:
                continue
            flags = model_dir_flags(arch, mode)
            with captured_runs(cli, {}) as seeded:
                _, seeded_ms = run_cli(cli, flags)
            del seeded["model"]
            torch.cuda.empty_cache()
            zero_counts(counters)
            with captured_runs(cli, {}) as rec:
                res, ms = run_cli(cli, flags + ["--model-dir", path])
            counts = read_counts(counters)
            model_state = {k: v for k, v in rec.pop("model").state_dict().items()
                           if k in ported}
            equal = all(torch.equal(model_state[k].cpu(), v) for k, v in ported.items())
            logits, ref = torch.cat(rec["logits"]), torch.cat(seeded["logits"])
            differ = not torch.equal(logits, ref)
            want = model_dir_expected(arch, mode)
            ok = (not unused and len(model_state) == len(ported) and equal and differ
                  and all(counts[k] == want.get(k, 0) for k in counts)
                  and np.isfinite(res["metrics"]["loss"]) and bool(torch.isfinite(logits).all()))
            phase("main", f"{arch} {mode} --model-dir {os.path.basename(path)} ({mb:.1f} MiB, "
                          f"{len(state)} tensors): write {t1 - t0:.2f} s, torch.load "
                          f"{t2 - t1:.2f} s, porting {t3 - t2:.3f} s; unread tensors {unused} "
                          f"(BN counters aside); {len(ported)} ported entries equal to the "
                          f"file's after the layout change: {equal}; logits differ from the "
                          f"seeded-init run: {differ} (max|d| "
                          f"{float((logits - ref).abs().max()):.3g}); {res['metrics']}, "
                          f"{ms:.2f} ms/img (the seeded run {seeded_ms:.2f}; {card_power()}), "
                          f"launches {counts}, ok={ok}")
            if not ok:
                raise SystemExit(f"--model-dir {arch} {mode}: the file did not load as ported")
            out[f"{arch} {mode}"] = {"counts": counts, "ms": ms, "seeded_ms": seeded_ms,
                                     "metrics": res["metrics"], "load_s": t2 - t1,
                                     "port_s": t3 - t2, "mib": mb}
            del model_state, rec, seeded
            torch.cuda.empty_cache()
        del state, loaded, used, ported
        os.remove(path)
    return out


@contextlib.contextmanager
def setup_states(cli, record):
    """Records, for every ``validate-quantized`` run inside, its model's
    ``state_dict`` on the host right after ``cli.setup`` (the init forward
    and ``--model-dir`` done), in ``record["states"]``."""
    setup = cli.setup
    record["states"] = []

    def setup_call(args):
        out = setup(args)
        record["states"].append({k: v.detach().cpu().clone()
                                 for k, v in out[0].state_dict().items()})
        return out

    cli.setup = setup_call
    try:
        yield record
    finally:
        cli.setup = setup


def run_checkpoint(cli, counters, tmp):
    """ViT-B/16 ``--fast-mode --packed-weights`` with ``--save-checkpoint-dir``,
    then a fresh run restored from it through ``--model-dir <dir>``: every
    buffer of the restored model (weights, site state, ``mantissa_bits``,
    BN-free ViT's weight caches and packed codes) equal to the saved model's
    after its run; both runs' metrics and ms/img printed."""
    import os

    ckpt = os.path.join(tmp, "checkpoint")
    flags = SERVING_FLAGS["packed"]
    zero_counts(counters)
    with captured_runs(cli, {}) as rec:
        saved, ms = run_cli(cli, flags + ["--save-checkpoint-dir", ckpt])
    counts = read_counts(counters)
    final = {k: v.detach().cpu() for k, v in rec.pop("model").state_dict().items()}
    mib = os.path.getsize(saved["checkpoint"]) / 2 ** 20
    zero_counts(counters)
    with setup_states(cli, {}) as st:
        restored, ms2 = run_cli(cli, flags + ["--model-dir", ckpt])
    counts2 = read_counts(counters)
    state = st["states"][0]
    same_keys = set(state) == set(final)
    bad = [k for k in final if k not in state or state[k].dtype != final[k].dtype
           or not torch.equal(state[k], final[k])]
    kinds = {name: sum(1 for k in final if k.endswith(name))
             for name in (".w_codes", ".w_q", ".mantissa_bits", ".kernel")}
    ok = (same_keys and not bad and kinds[".w_codes"] >= DENSE_LAUNCHES_PER_FORWARD
          and counts2 == counts and np.isfinite(restored["metrics"]["loss"]))
    phase("main", f"vit_quantized --fast-mode --packed-weights --save-checkpoint-dir: "
                  f"{saved['metrics']}, {ms:.2f} ms/img; checkpoint {mib:.1f} MiB, "
                  f"{len(final)} buffers ({kinds}); restored through --model-dir: {len(bad)} "
                  f"buffers differ from the saved model's, {restored['metrics']}, {ms2:.2f} "
                  f"ms/img ({card_power()}), launches {counts2} (the saving run's {counts}), "
                  f"ok={ok}")
    if not ok:
        raise SystemExit(f"checkpoint round trip: {bad[:5]} differ")
    os.remove(saved["checkpoint"])
    return {"ms": ms, "restored_ms": ms2, "mib": mib, "counts": counts2}


def write_image_folder(root, per_class=8, classes=("0", "1"), seed=0):
    """``root/{train,val}/<class>/``: JPEG and PNG images, smooth gradients
    with noise, sides 180..420 (portrait and landscape)."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        for ci, cls in enumerate(classes):
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(per_class):
                w, h = (int(v) for v in rng.integers(180, 420, size=2))
                yy, xx = np.mgrid[0:h, 0:w]
                arr = np.stack([xx * 255 / (w - 1), yy * 255 / (h - 1),
                                rng.uniform(0, 255, (h, w))], axis=-1).astype(np.uint8)
                img = Image.fromarray(arr)
                if (i + ci) % 2:
                    img.save(os.path.join(d, f"img_{i}.png"))
                else:
                    img.save(os.path.join(d, f"img_{i}.jpg"), quality=95)


def run_images_dir(cli, counters, tmp):
    """ViT-B/16 on the published flags with ``--images-dir`` (evaluation
    from ``val/``, calibration from ``train/``): through the PIL pipeline,
    and through ``--native-loader`` where ``runtime/image_loader.cc`` builds
    here (g++, libjpeg, libpng); the two loaders' val batches within
    ``tests/test_native_loader.py``'s tolerance. What is missing on this
    machine is printed, with what could not run. Returns {loader: ms/img}."""
    import os

    from fp8_quantization_tpu_torch.eval import data, native_data

    try:
        import PIL
    except ImportError:
        phase("main", "--images-dir: Pillow is missing, so neither the image "
                      "folder could be written nor the PIL pipeline run; the native loader "
                      "was not run either (its batches are held to the PIL ones)")
        return {}
    root = os.path.join(tmp, "images")
    write_image_folder(root)
    flags = [f for f in PUBLISHED_FLAGS if f != "--synthetic-data"] + ["--images-dir", root]
    native = native_data.available()
    runs = {"PIL": flags} | ({"native": flags + ["--native-loader", "--num-workers", "8"]}
                             if native else {})
    if not native:
        phase("main", f"--images-dir: the native loader does not build here "
                      f"({native_data.build_error}); the PIL pipeline runs alone")
    out = {}
    for loader, argv in runs.items():
        zero_counts(counters)
        res, ms = run_cli(cli, argv)
        counts = read_counts(counters)
        ok = (res["images"] == 8 + 16 and np.isfinite(res["metrics"]["loss"])
              and not any(counts.values()))
        phase("main", f"vit_quantized --images-dir ({loader} loader, Pillow {PIL.__version__}): "
                      f"{res['metrics']}, {ms:.2f} ms/img over {res['images']} images "
                      f"({card_power()}), launches {counts}, ok={ok}")
        if not ok:
            raise SystemExit(f"--images-dir with the {loader} loader failed")
        out[loader] = ms
    if native:
        tol = 2.0 / 255.0 / float(min(data.IMAGENET_STD))
        worst, mean = 0.0, 0.0
        pil = list(data.imagenet_val_batches(root, BATCH, image_size=224))
        nat = list(native_data.imagenet_val_batches_native(root, BATCH, image_size=224))
        for (x, y), (nx, ny) in zip(pil, nat):
            d = np.abs(x - nx)
            worst, mean = max(worst, float(d.max())), max(mean, float(d.mean()))
            if not np.array_equal(y, ny):
                raise SystemExit("the native loader's labels differ from the PIL pipeline's")
        ok = len(pil) == len(nat) == 2 and worst <= tol and mean <= tol / 4
        phase("main", f"--images-dir loaders: native against PIL over {len(pil)} val batches: "
                      f"max |d| {worst:.4g} (limit {tol:.4g}), largest batch mean {mean:.4g} "
                      f"(limit {tol / 4:.4g}), ok={ok}")
        if not ok:
            raise SystemExit("the native loader's batches leave the PIL pipeline's tolerance")
    return out


def run_weights_and_surgery(cli, counters, dev):
    """Phase 4's weights, images, demo and surgery runs; returns their
    records and wall seconds."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    rec = {"demo": {mode: run_demo(cli, counters, mode) for mode in DEMO_RUNS},
           "surgery": {mode: run_surgery(cli, counters, dev, mode) for mode in SURGERY_MODES}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        rec["model_dir"] = run_model_dir(cli, counters, tmp)
        rec["checkpoint"] = run_checkpoint(cli, counters, tmp)
        rec["images"] = run_images_dir(cli, counters, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t0
    return rec


# ---------------------------------------------------------------------------
# BERT-base: the nlp entry point (GLUE evaluation) and BERT's serving modes
# (scripts/bench_bert.py) at full width
BERT_BATCH, BERT_SEQ = 32, 128
BERT_DEPTH2_BATCH = 32
BERT_TIMED = 5
BERT_NLP_EVALS = 2
# int8 dense products go through fastpath.quantized_matmul_int8 (torch._int_mm
# on the card), which has no launch counter of its own
BERT_COUNTED = (("layers", "quantized_matmul_int8", "int8 dense"),)


def bert_spec(depth=None):
    from fp8_quantization_tpu_torch.models.bert import BERT_BASE

    return BERT_BASE if depth is None else dataclasses.replace(BERT_BASE, num_layers=depth)


# BERT-base's dense products at batch B x T tokens: (name, M, K, N, per forward)
def bert_dense_shapes(batch=BERT_BATCH, seq=BERT_SEQ):
    m = batch * seq
    return [("qkv_attn_out", m, 768, 768, 4 * 12),
            ("intermediate", m, 768, 3072, 12),
            ("output", m, 3072, 768, 12),
            ("pooler", batch, 768, 768, 1),
            ("classifier", batch, 768, 2, 1)]


# phase 3's K2/K4 checks at BERT's shapes: the 4096-row products, the 32-row
# pooler and the 2-column classifier (route B, N * 2 bytes off 16)
BERT_GEMM_SHAPES = [(m, k, n) for _, m, k, n, _ in bert_dense_shapes()]


def bert_per_forward(spec):
    """(dense products, K1 launches) of one FAST or FP8 PACKED forward: K1
    at every dense layer's input and result site, every LayerNorm's input
    site (two a block and the embeddings') and every block's context and
    intermediate sites."""
    dense = 6 * spec.num_layers + 2
    return dense, 2 * dense + (2 * spec.num_layers + 1) + 2 * spec.num_layers


def bert_expected(spec, mode):
    """The launches one forward of ``mode`` implies: none in fp32, fixed
    and the int8 configuration's fast; K1 and K2 under FAST; K1 and K4
    under FP8 PACKED; int8 packed and chained no kernel, every dense
    product an int8 one."""
    from fp8_quantization_tpu_torch.ops.cuda import KERNELS

    dense, k1 = bert_per_forward(spec)
    want = {name: 0 for name in KERNELS}
    want["int8 dense"] = 0
    if mode in ("fast", "fp8 packed"):
        want["K1"] = k1
        want["K2" if mode == "fast" else "K4"] = dense
    elif mode in ("int8 packed", "int8 chained"):
        want["int8 dense"] = dense
    return want


def forward_ms(fn, reps=BERT_TIMED):
    """Median milliseconds of ``fn`` over ``reps`` runs, each between two
    CUDA events, after one warm-up run: the time a batch takes, host
    launches included."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def busy_share(fn):
    """``torch.profiler`` over one run of ``fn``: (wall ms, device ms,
    kernel launches). The profiler's own host cost inflates the wall, so
    device / wall understates the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own events (kernels, copies, memsets): a host op's
    # device time repeats its kernels' time
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0) for e in kernels)
    return 1e3 * wall, device_us / 1e3, sum(e.count for e in kernels)


@contextlib.contextmanager
def captured_nlp(record):
    """Records, for every ``nlp`` run inside, its model (``record["model"]``)
    and the synced seconds of its ESTIMATE forwards, the init forward among
    them (``record["calib_s"]``), and of its FIXED ones
    (``record["eval_s"]``)."""
    from fp8_quantization_tpu_torch import nlp

    forward = nlp.forward
    record.update(calib_s=0.0, eval_s=0.0)

    def call(model, ids, mask=None, types=None, qp=nlp.FIXED):
        record["model"] = model
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(model, ids, mask, types, qp)
        torch.cuda.synchronize()
        record["calib_s" if qp.estimating else "eval_s"] += time.perf_counter() - t0
        return out

    nlp.forward = call
    try:
        yield record
    finally:
        nlp.forward = forward


def run_nlp(counters, name, argv):
    """``python -m fp8_quantization_tpu_torch.nlp`` with ``argv``, every
    count zeroed just before it: the published flags launch no kernel (the
    calibration and the FIXED evaluation run the plain quantizers and f32
    products). Returns (run record, counts)."""
    from fp8_quantization_tpu_torch import nlp

    zero_counts(counters)
    with counted_calls({}, BERT_COUNTED) as calls, captured_nlp({}) as rec:
        t0 = time.perf_counter()
        metrics = nlp.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {**read_counts(counters), **calls}
    device = next(rec["model"].parameters()).device
    ok = (not any(counts.values()) and all(0.0 <= v <= 1.0 for v in metrics.values())
          and device.type == "cuda")
    phase("main", f"nlp {name} on {device}: {metrics}, ESTIMATE forwards (the init one "
                  f"included) {rec['calib_s']:.2f} s, FIXED eval {rec['eval_s']:.2f} s, wall "
                  f"{wall:.2f} s ({card_power()}), launches {counts}, ok={ok}")
    if not ok:
        raise SystemExit(f"nlp {name}: launched a kernel, left the card or gave bad metrics")
    return {**rec, "metrics": metrics, "wall_s": wall}, counts


def write_glue_folder(root, seed=10):
    """An SST-2-format folder (``dev.tsv``, ``train.tsv``, with headers) and
    a ``vocab.txt``: the synthetic task's sentences and vocabulary."""
    import os

    from fp8_quantization_tpu_torch.eval import glue

    os.makedirs(root, exist_ok=True)
    _, examples, _ = glue.synthetic_task(num_examples=40, seed=seed)
    for name, rows in (("dev.tsv", examples[:32]), ("train.tsv", examples[32:])):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("sentence\tlabel\n")
            f.writelines(f"{ex.text_a}\t{int(ex.label)}\n" for ex in rows)
    with open(os.path.join(root, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(glue.synthetic_vocab()) + "\n")
    return root


def run_nlp_runs(counters, tmp):
    """The three ``nlp`` runs at full BERT-base width on the card: the
    synthetic task under the published E5M2 flags; ``--model-dir`` on a
    seeded state dict under HF ``BertForSequenceClassification``'s names
    that this function writes (read and ported here as well, timed, to
    count the tensors the port leaves unread; every ported entry of the
    run's model equal to the file's after its layout change); ``--data-dir``
    on a written SST-2 folder. Returns {run: record}."""
    import os

    from fp8_quantization_tpu_torch.models import porting

    flags = ["--max-eval-batches", str(BERT_NLP_EVALS)]
    out = {}
    rec, counts = run_nlp(counters, "synthetic task, E5M2", flags)
    del rec["model"]
    out["synthetic"] = {**rec, "counts": counts}
    path = os.path.join(tmp, "bert_sst2.bin")
    t0 = time.perf_counter()
    state = porting.seeded_source_state("bert_quantized", torch.Generator().manual_seed(7))
    torch.save(state, path)
    t1 = time.perf_counter()
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    t2 = time.perf_counter()
    used = porting.UsedKeys(loaded)
    layers = bert_spec().num_layers
    ported = porting.port_bert(used, layers)
    t3 = time.perf_counter()
    unread = porting.unported_keys(used)
    rec, counts = run_nlp(counters, "--model-dir", flags + ["--model-dir", path])
    model_state = rec.pop("model").state_dict()
    equal = all(torch.equal(model_state[k].cpu(), v) for k, v in ported.items())
    # three embeddings and their LayerNorm, 16 entries a layer, pooler, classifier
    ok = equal and unread == () and len(ported) == 5 + 16 * layers + 4
    phase("main", f"nlp --model-dir {os.path.basename(path)} ({os.path.getsize(path) / 2**20:.1f} "
                  f"MiB, {len(state)} tensors): write {t1 - t0:.2f} s, torch.load "
                  f"{t2 - t1:.2f} s, porting {t3 - t2:.3f} s; unread tensors {unread}; "
                  f"{len(ported)} ported entries equal to the file's after the layout change: "
                  f"{equal}; ok={ok}")
    if not ok:
        raise SystemExit("nlp --model-dir: the file did not load as ported")
    out["--model-dir"] = {**rec, "counts": counts, "write_s": t1 - t0, "load_s": t2 - t1,
                          "port_s": t3 - t2}
    del state, loaded, used, model_state, ported
    os.remove(path)
    folder = write_glue_folder(os.path.join(tmp, "sst-2"))
    rec, counts = run_nlp(counters, "--data-dir", ["--data-dir", folder, "--task", "sst-2"])
    del rec["model"]
    out["--data-dir"] = {**rec, "counts": counts}
    torch.cuda.empty_cache()
    return out


def run_bert_serving(dev, counters):
    """``scripts/bench_bert.py``'s modes at full BERT-base width on its
    ragged batch (32 x 128, the second half masked past 60%): the FP8
    family (``nlp.fp8_modes``: fp32, fixed, fast, FP8 packed) and the int8
    family (``nlp.int8_modes``: its FAST, int8 packed, int8 chained), each
    model built, initialized on the first row and calibrated on two. Per
    mode: launches of one forward (counts zeroed just before it) held to
    :func:`bert_expected`, ms a batch (CUDA events, median of
    ``BERT_TIMED``) and the profiled busy share; the top-1 agreement of the
    int8 modes with the int8 configuration's FAST, held to the JAX
    package's 0.95 (``tests/test_glue_serving.py``). Returns {mode: record}."""
    from fp8_quantization_tpu_torch import nlp

    spec = bert_spec()
    ids, mask = nlp.ragged_batch(spec, BERT_BATCH, BERT_SEQ)
    ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    out = {}
    for qc, modes in ((nlp.fp8_serving_qc(), nlp.fp8_modes),
                      (nlp.int8_serving_qc(), nlp.int8_modes)):
        model = nlp.serving_model(qc, spec, ids, mask, dev, torch.Generator().manual_seed(0))
        for mode, qp in modes(model, qc, ids, mask):
            def run(qp=qp):
                with torch.no_grad():
                    return model(ids_t, mask_t, None, qp=qp)

            zero_counts(counters)
            with counted_calls({}, BERT_COUNTED) as calls:
                logits = run().float()
                torch.cuda.synchronize()
            counts = {**read_counts(counters), **calls}
            want = bert_expected(spec, mode)
            ms = forward_ms(run)
            wall_ms, device_ms, launches = busy_share(run)
            ok = counts == want and bool(torch.isfinite(logits).all())
            phase("main", f"BERT-base {mode} at {BERT_BATCH}x{BERT_SEQ}: {ms:.2f} ms a batch "
                          f"(median of {BERT_TIMED}; {card_power()}), profiled {wall_ms:.2f} ms "
                          f"wall / {device_ms:.2f} device ms (busy share "
                          f"{device_ms / wall_ms:.3f}, {launches} kernel launches), launches "
                          f"{counts} (expected {want}), ok={ok}")
            if not ok:
                raise SystemExit(f"BERT {mode}: wrong launch counts or non-finite logits")
            out[mode] = {"counts": counts, "ms": ms, "busy": device_ms / wall_ms,
                         "device_ms": device_ms, "top1": logits.argmax(-1).cpu()}
        del model
        torch.cuda.empty_cache()
    for mode in ("int8 packed", "int8 chained"):
        agree = float((out[mode]["top1"] == out["int8 fast"]["top1"]).float().mean())
        out[mode]["agreement"] = agree
        phase("main", f"BERT-base {mode}: top-1 agreement with the int8 configuration's FAST "
                      f"{agree:.4f} over {BERT_BATCH} sequences (at least 0.95)")
        if agree < 0.95:
            raise SystemExit(f"BERT {mode}: top-1 agreement with FAST below 0.95")
    return out


def check_bert_models(dev, counters):
    """Phase 5: a depth-2 full-width BERT at 32 x 128 (ragged). FP8: FAST
    and FP8 PACKED through the kernels, every K2/K4 call held to its
    contract and every K1 call to equality on its own inputs, against the
    same model through the plain versions (no launch from the plain run).
    Route B's tensor cores sum in their own order, and a requant output at a
    rounding midpoint lands one grid step away and carries on; with two
    classes one such step in the logits (0.0625 on the classifier's E3M4
    grid near 1) is a relative RMS near 0.017 over 16 logits and 0.009
    over this batch's 64, so ``compare_logits``'s 1e-2 does not fit, and
    the plain path's readings (``plain_path_readings``) both fall below
    ``RMS_LIMIT``: the lower-precision control reads ~0.03 (the logits
    move in whole grid steps). The logits' relative RMS is held to at most
    ``RMS_LIMIT`` and the midpoint of the two readings taken in this run,
    the legal-order one below the control, and to the same top-1 wherever
    the plain margin exceeds twice max|kernel - plain|. Then FAST through
    the kernels against FIXED within ``RMS_LIMIT``. int8: CHAINED against
    PACKED with the same top-1 and within the JAX package's ``rtol = atol =
    5e-4`` (``tests/test_conv_serving.py``)."""
    from fp8_quantization_tpu_torch import nlp

    spec = bert_spec(2)
    ids, mask = nlp.ragged_batch(spec, BERT_DEPTH2_BATCH, BERT_SEQ, seed=3)
    ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    qc = nlp.fp8_serving_qc()
    model = nlp.serving_model(qc, spec, ids, mask, dev, torch.Generator().manual_seed(1))
    logits = {}
    for mode, qp in nlp.fp8_modes(model, qc, ids, mask):
        def forward(qp=qp):
            with torch.no_grad():
                return model(ids_t, mask_t, None, qp=qp).float()

        if mode in ("fp32", "fixed"):
            logits[mode] = forward()
            continue
        zero_counts(counters)
        with verified_gemms({}) as record, verified_attention({}) as held:
            ours = forward()
        counts = read_counts(counters)
        with plain_kernels():
            plain = forward()
        dense, k1 = bert_per_forward(spec)
        gemm = "K2" if mode == "fast" else "K4"
        diff = float((ours - plain).abs().max())
        rms = rel_rms(ours, plain)
        legal, control = plain_path_readings(forward, plain)
        limit = min(RMS_LIMIT, (legal + control) / 2)
        rms_ok = rms <= limit and legal < control
        rms_line = (f"relative RMS {rms:.4g} (limit {limit:.4g}: at most {RMS_LIMIT} and "
                    f"midway between the plain path with the GEMM sums in another legal order "
                    f"{legal:.4g} and in the lower-precision control {control:.4g})")
        top2 = torch.sort(plain, dim=-1).values[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * diff
        same = bool((ours.argmax(-1) == plain.argmax(-1))[decided].all())
        ok = (counts[gemm] == dense and counts["K1"] == k1 and held["K1"] == k1
              and record["calls"] == dense and read_counts(counters) == counts and rms_ok
              and same and bool(torch.isfinite(ours).all()))
        phase("model", f"BERT {mode}, width {spec.hidden_size}, depth {spec.num_layers}, batch "
                       f"{BERT_DEPTH2_BATCH}: {record['calls']} {gemm} calls (routes "
                       f"{sorted(record['routes'])}) each within its contract with plain on its "
                       f"own inputs (min equal fraction {record['min_equal']:.4f}), {held['K1']} "
                       f"K1 calls equal; logits max|kernel - plain| {diff:.3g} (max|logit| "
                       f"{float(plain.abs().max()):.3g}), {rms_line}, same top-1 on the "
                       f"{int(decided.sum())} of {BERT_DEPTH2_BATCH} rows whose plain margin "
                       f"exceeds 2 max|d|: {same}, launches {counts}, ok={ok}")
        if not ok:
            raise SystemExit(f"BERT depth 2 {mode}: the kernels and their plain versions disagree")
        logits[mode] = ours
    rms = rel_rms(logits["fast"], logits["fixed"])
    ok = rms <= RMS_LIMIT
    agree = float((logits["fast"].argmax(-1) == logits["fixed"].argmax(-1)).float().mean())
    phase("model", f"BERT FAST through the kernels against FIXED, depth 2, batch "
                   f"{BERT_DEPTH2_BATCH}: relative RMS {rms:.4g} (limit {RMS_LIMIT}), top-1 "
                   f"agreement {agree:.3f}, ok={ok}")
    if not ok:
        raise SystemExit("BERT FAST and FIXED disagree beyond RMS_LIMIT")
    del model
    qc = nlp.int8_serving_qc()
    model = nlp.serving_model(qc, spec, ids, mask, dev, torch.Generator().manual_seed(1))
    with torch.no_grad():
        served = {mode: model(ids_t, mask_t, None, qp=qp).float()
                  for mode, qp in nlp.int8_modes(model, qc, ids, mask)}
    packed, chained = served["int8 packed"], served["int8 chained"]
    diff = float((chained - packed).abs().max())
    close = bool(torch.all((chained - packed).abs() <= 5e-4 + 5e-4 * packed.abs()))
    same = bool((chained.argmax(-1) == packed.argmax(-1)).all())
    ok = close and same and bool(torch.isfinite(chained).all())
    phase("model", f"BERT int8 CHAINED against PACKED, depth 2, batch {BERT_DEPTH2_BATCH}: "
                   f"max|d| {diff:.3g} (bit-equal {torch.equal(chained, packed)}; max|logit| "
                   f"{float(packed.abs().max()):.3g}), same top-1 {same}, ok={ok}")
    if not ok:
        raise SystemExit("BERT int8 CHAINED and PACKED disagree")
    del model
    torch.cuda.empty_cache()


def run_bert(dev, counters):
    """Phase 4's BERT runs: ``nlp`` three ways, then the serving modes.
    Returns {"nlp", "serving", "seconds"}."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bert_")
    try:
        nlp_runs = run_nlp_runs(counters, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    serving = run_bert_serving(dev, counters)
    return {"nlp": nlp_runs, "serving": serving, "seconds": time.perf_counter() - t0}


# train-qat: MobileNetV2 at full width (224x224, 1000 classes),
# batch 32, 2 epochs of 4 steps; the timing ladder takes QAT_RUNG_STEPS
# steps a rung after one warm-up step
QAT_BATCH = 32
QAT_EPOCHS, QAT_STEPS = 2, 4
QAT_RUNG_STEPS = 5
# (b): 4-bit symmetric per-channel weights, 8-bit acts, LSQ scaling; a
# weight freezes at its first direction reversal (EMA momentum 0.5 puts its
# frequency at 0.5 > 0.2), and the rate makes codes flip within the run
OSC_FLAGS = ["--n-bits", "4", "--n-bits-act", "8", "--grad-scaling", "--learning-rate",
             "0.1", "--oscillations-dampen-weight", "0.1",
             "--oscillations-freeze-threshold", "0.2",
             "--oscillations-freeze-ema-momentum", "0.5"]
# (c): the card's step against the CPU's, MobileNetV2 at full width with
# one block a stage (every stride kept, so the pool still sees 7x7), batch 2
QAT_CUT_SETTING = ((1, 16, 1, 1), (6, 24, 1, 2), (6, 32, 1, 2), (6, 64, 1, 2),
                   (6, 96, 1, 1), (6, 160, 1, 2), (6, 320, 1, 1))
QAT_CHECK_BATCH = 2


def qat_flags(mode, tmp):
    """``train-qat`` on MobileNetV2 at batch ``QAT_BATCH``: (a) ``fp8``,
    ``scripts/image_net.sh``'s flags with learnable maxval and a separate
    range optimizer; (b) ``osc``, the int8 flags at 4-bit weights with LSQ
    and ``OSC_FLAGS``. Both save ``<tmp>/latest``."""
    flags = cnn_flags("mobilenet_v2_quantized",
                      "published" if mode == "fp8" else "int8 packed")
    flags[0] = "train-qat"
    flags[flags.index("--batch-size") + 1] = str(QAT_BATCH)
    flags = [f for f in flags if f != "--packed-weights"]
    flags += (["--fp8-learn-maxval", "--sep-quant-optimizer"] if mode == "fp8" else OSC_FLAGS)
    return flags + ["--max-epochs", str(QAT_EPOCHS), "--steps-per-epoch", str(QAT_STEPS),
                    "--reestimate-bn-batches", str(QAT_STEPS), "--save-checkpoint-dir", tmp]


@contextlib.contextmanager
def captured_qat(cli, record):
    """Records, for the ``train-qat`` run inside, its model
    (``record["model"]``), its trainable ranges after calibration
    (``record["ranges"]``), each step's loss and synced wall seconds, and,
    with freezing on, after each step the number of frozen weights whose
    code is not their target (``record["unpinned"]``, summed) and the
    frozen fraction (``record["frozen"]``)."""
    from fp8_quantization_tpu_torch.eval import trainer
    from fp8_quantization_tpu_torch.quant import oscillations as osc

    setup, make_step = cli.setup, trainer.make_qat_step
    record.update(losses=[], step_s=[], unpinned=0, frozen=[])

    def setup_call(args):
        out = setup(args)
        record["model"], record["qc"] = out[0], out[2]
        return out

    def make_step_call(model, *args, **kw):
        step, init_state = make_step(model, *args, **kw)

        def init_call(m):
            state = init_state(m)
            record["ranges"] = {k: t.detach().clone() for k, t in state.quant_train.items()}
            return state

        def step_call(state, x, y):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, x, y)
            torch.cuda.synchronize()
            record["step_s"].append(time.perf_counter() - t0)
            record["losses"].append(float(loss))
            fstate = state.osc.get("freeze")
            if fstate:
                wq = record["qc"].weight_quantizer()
                with torch.no_grad():
                    for path, w, q in osc.iter_weight_sites(model):
                        s = fstate[path]
                        x_int, _, _ = osc._int_coords(wq, q, w)
                        record["unpinned"] += int((x_int != s["target_int"])[s["frozen"]].sum())
                record["frozen"].append(float(osc.frozen_fraction(fstate)))
            return state, loss

        return step_call, init_call

    cli.setup, trainer.make_qat_step = setup_call, make_step_call
    try:
        yield record
    finally:
        cli.setup, trainer.make_qat_step = setup, make_step


def run_train_qat(cli, counters, mode, tmp):
    """One ``train-qat`` run (:func:`qat_flags`) with every count zeroed just
    before it: no kernel launches, the loss is finite in every epoch, and
    the run's ``latest`` checkpoint restores to equal logits; ``fp8``: at
    least one ``maxval`` moved; ``osc``: some weights froze and every frozen
    weight kept its code. Returns its summary."""
    import os

    from fp8_quantization_tpu_torch.quant.sites import ESTIMATE, FIXED
    from fp8_quantization_tpu_torch.utils.checkpoint import load_checkpoint

    argv = qat_flags(mode, tmp)
    args = cli.build_parser().parse_args(argv)
    zero_counts(counters)
    t0 = time.perf_counter()
    with captured_qat(cli, {}) as rec:
        last = cli.run_train_qat(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    model = rec["model"]
    moved = sum(int((t.detach() != rec["ranges"][k]).sum())
                for k, t in model.state_dict(keep_vars=True).items() if k in rec["ranges"])
    # the checkpoint, restored into a model built afresh, gives equal logits
    dev = next(model.parameters()).device
    fresh, example = cli.build_model(args.architecture, rec["qc"], dev, torch.Generator())
    with torch.no_grad():
        fresh(example, ESTIMATE)
        load_checkpoint(os.path.join(tmp, "latest"), fresh)
        x = torch.randn((2, CNN_SIZE, CNN_SIZE, 3), generator=torch.Generator().manual_seed(3)
                        ).to(dev)
        restored = torch.equal(fresh(x, FIXED), model(x, FIXED))
    losses = rec["losses"]
    finite = bool(np.isfinite(losses).all()) and np.isfinite(last["loss"])
    ok = (not any(counts.values()) and finite and restored
          and len(losses) == QAT_EPOCHS * QAT_STEPS)
    if mode == "fp8":
        ok = ok and moved > 0
    else:
        ok = ok and rec["frozen"][-1] > 0 and rec["unpinned"] == 0
    step_ms = 1e3 * float(np.median(rec["step_s"][1:]))
    phase("main", f"train-qat mobilenet_v2_quantized {mode}, batch {QAT_BATCH}, "
                  f"{QAT_EPOCHS}x{QAT_STEPS} steps ({card_power()}): losses "
                  f"{[round(v, 4) for v in losses]}, last epoch {last}, {moved} trainable range "
                  f"entries moved of {sum(t.numel() for t in rec['ranges'].values())}, "
                  + (f"frozen fraction a step {[f'{v:.3g}' for v in rec['frozen']]}, frozen "
                     f"weights off their code {rec['unpinned']}, " if mode == "osc" else "")
                  + f"checkpoint restores to equal logits {restored}, median step {step_ms:.1f} "
                  f"ms (synced), run {wall:.1f} s, launches {counts}, ok={ok}")
    if not ok:
        raise SystemExit(f"train-qat {mode}: a kernel launched, a loss is not finite, the "
                         "ranges or frozen codes misbehaved, or the checkpoint differs")
    del fresh
    return {"counts": counts, "losses": losses, "step_ms": step_ms, "wall_s": wall,
            "frozen": rec["frozen"][-1] if rec["frozen"] else None, "moved": moved}


def _updates(model, before):
    return {k: (t.detach().float().cpu() - before[k]) for k, t in
            model.state_dict().items() if k in before}


def check_qat_step(cli, dev):
    """(c): one QAT step (SGD with momentum, ranges in the same optimizer)
    of MobileNetV2 at full width, cut to one block a stage
    (``QAT_CUT_SETTING``), batch ``QAT_CHECK_BATCH``, on the card and on the
    CPU from one calibrated state: the relative RMS of the card's weight and
    range updates against the CPU's, held to ``RMS_LIMIT``."""
    import copy

    from fp8_quantization_tpu_torch.models import mobilenet_v2
    from fp8_quantization_tpu_torch.quant import qat
    from fp8_quantization_tpu_torch.quant.sites import ESTIMATE

    args = cli.build_parser().parse_args(qat_flags("fp8", "unused"))
    qc = cli.config_from_args(args)
    saved = mobilenet_v2.INVERTED_RESIDUAL_SETTING
    mobilenet_v2.INVERTED_RESIDUAL_SETTING = QAT_CUT_SETTING
    try:
        cpu = torch.device("cpu")
        model, example = cli.build_model(args.architecture, qc, cpu,
                                         torch.Generator().manual_seed(10))
    finally:
        mobilenet_v2.INVERTED_RESIDUAL_SETTING = saved
    gen = torch.Generator().manual_seed(11)
    calib = torch.randn((QAT_CHECK_BATCH, CNN_SIZE, CNN_SIZE, 3), generator=gen)
    x = torch.randn((QAT_CHECK_BATCH, CNN_SIZE, CNN_SIZE, 3), generator=gen)
    y = torch.randint(0, 1000, (QAT_CHECK_BATCH,), generator=gen)
    with torch.no_grad():
        model(example, ESTIMATE)
        model(calib, ESTIMATE)
    card = copy.deepcopy(model).to(dev)
    before = {k: v.detach().float().clone() for k, v in model.state_dict().items()}
    trainable = qat.trainable_range_params(qc)
    losses, updates = {}, {}
    for name, m in (("cpu", model), ("card", card)):
        step, init = qat.make_qat_step(m, qat.make_optimizer("SGD", 1e-2, 0.9), trainable=trainable)
        _, loss = step(init(m), x.to(next(m.parameters()).device), y)
        losses[name] = float(loss)
        updates[name] = _updates(m, before)
    num = sum(float(((updates["card"][k] - u) ** 2).sum()) for k, u in updates["cpu"].items())
    den = sum(float((u ** 2).sum()) for u in updates["cpu"].values())
    rms = (num / den) ** 0.5
    ranges = [k for k in updates["cpu"] if k.rsplit(".", 1)[1] in trainable]
    moved = sum(int((updates["cpu"][k] != 0).sum()) for k in ranges)
    ok = rms <= RMS_LIMIT and np.isfinite(losses["card"]) and moved > 0
    phase("model", f"QAT step, MobileNetV2 width 1.0 cut to {len(QAT_CUT_SETTING)} blocks, batch "
                   f"{QAT_CHECK_BATCH}: loss card {losses['card']:.6f} / CPU {losses['cpu']:.6f}, "
                   f"relative RMS of the weight and range updates {rms:.4g} (limit {RMS_LIMIT}; "
                   f"{moved} range entries moved on the CPU), ok={ok}")
    if not ok:
        raise SystemExit("the card's QAT step and the CPU's disagree")
    del card
    return rms


def qat_ladder(cli, dev, counters):
    """(d): ms a step (CUDA events, median of ``QAT_RUNG_STEPS`` after one
    warm-up step), device launches a step and busy share (``busy_share``)
    at (a)'s shapes: plain f32 training, fake-quant training with frozen
    ranges (the FIXED phase, model parameters only) and QAT with learnable
    ranges (``make_qat_step``, Adam for the ranges), after
    ``scripts/bench_qat.py``'s decomposition. No kernel launches."""
    import torch.nn.functional as F

    from fp8_quantization_tpu_torch.eval.driver import calibrate
    from fp8_quantization_tpu_torch.quant import qat
    from fp8_quantization_tpu_torch.quant.sites import FIXED, FP32

    args = cli.build_parser().parse_args(qat_flags("fp8", "unused"))
    model, _, qc, _ = cli.setup(args)
    batches = list(cli.make_train_batches(args, model, 2))
    calibrate(model, batches[:1])
    x = torch.as_tensor(batches[1][0]).to(dev)
    y = torch.as_tensor(batches[1][1]).to(dev).long()

    def train_step(qp):
        params = list(model.parameters())
        opt = qat.make_optimizer("SGD", 1e-3, 0.9)(params)

        def run():
            for p in params:
                p.grad = None
            F.cross_entropy(model(x, qp), y).backward()
            opt.step()
        return run

    q_step, q_init = qat.make_qat_step(model, qat.make_optimizer("SGD", 1e-3, 0.9),
                                       qat.make_optimizer("Adam", 1e-4),
                                       trainable=qat.trainable_range_params(qc))
    rungs = {"plain f32 training": train_step(FP32),
             "fake-quant, frozen ranges": train_step(FIXED)}
    zero_counts(counters)
    out = {}
    for name, fn in rungs.items():
        out[name] = (forward_ms(fn, QAT_RUNG_STEPS), *busy_share(fn))
    state = [q_init(model)]

    def qat_run():
        state[0] = q_step(state[0], x, y)[0]
    out["QAT, learnable ranges"] = (forward_ms(qat_run, QAT_RUNG_STEPS), *busy_share(qat_run))
    qat.release_ranges(state[0])
    counts = read_counts(counters)
    for name, (ms, wall, device, launches) in out.items():
        phase("main", f"QAT ladder, MobileNetV2 width 1.0, batch {QAT_BATCH}, {name}: {ms:.2f} ms "
                      f"a step (median of {QAT_RUNG_STEPS}), {launches} device launches, busy "
                      f"{device / wall:.3f} ({device:.2f} device ms of a profiled {wall:.2f}) "
                      f"({card_power()})")
    if any(counts.values()):
        raise SystemExit(f"the QAT ladder launched a kernel: {counts}")
    del model
    return {name: {"ms": v[0], "launches": v[3], "busy": v[2] / v[1]} for name, v in out.items()}


def run_qat(cli, counters, dev):
    """The ``train-qat`` phase: (a) and (b) through the CLI, (c)
    the card's step against the CPU's, (d) the timing ladder. Returns its
    summary and wall seconds."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    runs = {}
    for mode in ("fp8", "osc"):
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_qat_{mode}_")
        try:
            runs[mode] = run_train_qat(cli, counters, mode, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    rms = check_qat_step(cli, dev)
    ladder = qat_ladder(cli, dev, counters)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    phase("qat", f"the train-qat phase took {seconds:.1f} s")
    return {"runs": runs, "rms": rms, "ladder": ladder, "seconds": seconds}


# ---------------------------------------------------------------------------
# A foreign ViT-B/16 quantized by interception, rank-3 convolutions,
# profiling and the grid check
# ---------------------------------------------------------------------------

FOREIGN_EVALS = 2
# K3 per forward of the intercepted foreign ViT-B/16: its 72 projections, the
# patch conv and the classifier (the port's QuantizedViT's count), and with
# the patch conv and the classifier filtered out
FOREIGN_K3_PER_FORWARD = LAUNCHES_PER_FORWARD
FOREIGN_UNFILTERED = ("vit.embeddings.patch_embeddings.projection", "classifier")
# the port's QuantizedViT: K3 ms per batch-8 forward (PERF.md §6, phase 3's timing)
PORT_VIT_K3_MS = 116.1
# K3's kernel in the profiler's trace
K3_KERNEL_NAME = "approx_matmul_kernel"


class _Dense(torch.nn.Module):
    """HF's one-``dense`` blocks (``ViTIntermediate``, ``ViTOutput``,
    ``ViTSelfOutput``)."""

    def __init__(self, i, o, act=None):
        super().__init__()
        self.dense = torch.nn.Linear(i, o)
        self.act = act

    def forward(self, x):
        y = self.dense(x)
        return y if self.act is None else self.act(y)


class _SelfAttention(torch.nn.Module):
    def __init__(self, h, heads):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value = (torch.nn.Linear(h, h) for _ in range(3))

    def forward(self, x):
        b, t, h = x.shape
        d = h // self.heads
        q, k, v = (p(x).view(b, t, self.heads, d).transpose(1, 2)
                   for p in (self.query, self.key, self.value))
        probs = torch.softmax(q @ k.transpose(-1, -2) / d ** 0.5, dim=-1)
        return (probs @ v).transpose(1, 2).reshape(b, t, h)


class _Attention(torch.nn.Module):
    def __init__(self, h, heads):
        super().__init__()
        self.attention = _SelfAttention(h, heads)
        self.output = _Dense(h, h)

    def forward(self, x):
        return self.output(self.attention(x))


class _Layer(torch.nn.Module):
    def __init__(self, s):
        super().__init__()
        h = s.hidden_size
        self.attention = _Attention(h, s.num_heads)
        self.intermediate = _Dense(h, s.mlp_dim, torch.nn.GELU())
        self.output = _Dense(s.mlp_dim, h)
        self.layernorm_before = torch.nn.LayerNorm(h, eps=s.layer_norm_eps)
        self.layernorm_after = torch.nn.LayerNorm(h, eps=s.layer_norm_eps)

    def forward(self, x):
        x = x + self.attention(self.layernorm_before(x))
        return x + self.output(self.intermediate(self.layernorm_after(x)))


class _PatchEmbeddings(torch.nn.Module):
    def __init__(self, s):
        super().__init__()
        self.projection = torch.nn.Conv2d(3, s.hidden_size, s.patch_size, stride=s.patch_size)


class _Embeddings(torch.nn.Module):
    def __init__(self, s):
        super().__init__()
        tokens = (s.image_size // s.patch_size) ** 2 + 1
        self.cls_token = torch.nn.Parameter(torch.zeros(1, 1, s.hidden_size))
        self.position_embeddings = torch.nn.Parameter(torch.zeros(1, tokens, s.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(s)

    def forward(self, x):
        p = self.patch_embeddings.projection(x).flatten(2).transpose(1, 2)
        return torch.cat([self.cls_token.expand(p.shape[0], -1, -1), p], 1) \
            + self.position_embeddings


class _Encoder(torch.nn.Module):
    def __init__(self, s):
        super().__init__()
        self.layer = torch.nn.ModuleList(_Layer(s) for _ in range(s.num_layers))

    def forward(self, x):
        for layer in self.layer:
            x = layer(x)
        return x


class _ViTModel(torch.nn.Module):
    def __init__(self, s):
        super().__init__()
        self.embeddings = _Embeddings(s)
        self.encoder = _Encoder(s)
        self.layernorm = torch.nn.LayerNorm(s.hidden_size, eps=s.layer_norm_eps)

    def forward(self, x):
        return self.layernorm(self.encoder(self.embeddings(x)))


class ForeignViT(torch.nn.Module):
    """A plain-PyTorch ViT-B/16 under HF ``ViTForImageClassification``'s
    module names (stock ``nn.Conv2d``, ``nn.Linear``, ``nn.LayerNorm``,
    ``nn.GELU``, softmax; NCHW images); it knows nothing of quantization."""

    def __init__(self, s):
        super().__init__()
        self.vit = _ViTModel(s)
        self.classifier = torch.nn.Linear(s.hidden_size, s.num_classes)

    def forward(self, x):
        return self.classifier(self.vit(x)[:, 0])


def foreign_vit(spec, dev, seed=17):
    """A ``ForeignViT`` on ``dev`` holding ``porting.seeded_source_state``'s
    seeded HF-named weights (loaded strictly; built on the meta device, so
    no init is computed and then thrown away)."""
    from fp8_quantization_tpu_torch.models.porting import seeded_source_state

    with torch.device("meta"):
        model = ForeignViT(spec)
    model = model.to_empty(device=dev)
    model.load_state_dict(seeded_source_state(
        "vit_quantized", torch.Generator().manual_seed(seed), spec=spec), strict=True)
    return model.eval()


def foreign_images(spec, batches, batch, seed, dev):
    """Synthetic NCHW images on ``dev``."""
    from fp8_quantization_tpu_torch.eval.data import synthetic_batches

    return [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dev)
            for x, _ in synthetic_batches(batch, batches, image_size=spec.image_size,
                                          num_classes=spec.num_classes, seed=seed)]


def flags_qc(cli, argv):
    return cli.config_from_args(cli.build_parser().parse_args(argv))


@contextlib.contextmanager
def verified_k3(record):
    """Every K3 call made inside goes to its kernel, and the first
    ``SLICE_ROWS`` rows of its result are held to the plain version on those
    rows of its own operands: bit for bit, or (f32 sums in another order)
    within ``K * 2^-24 * sum_k |term_k|`` as phase 3 holds K3. ``record``
    gathers {"calls", "equal" (bit for bit), "worst" |d|}."""
    from fp8_quantization_tpu_torch.numerics.approx_matmul import approx_products
    from fp8_quantization_tpu_torch.numerics.luts import get_error_table
    from fp8_quantization_tpu_torch.ops.cuda import approx_matmul as k3

    kernel = k3.approx_matmul
    record.update(calls=0, equal=0, worst=0.0)

    def call(a, b, bias_a, bias_b, bias_r, **kw):
        # the wrapper counts its launches under its module-level name
        k3.approx_matmul = kernel
        try:
            ours = kernel(a, b, bias_a, bias_b, bias_r, **kw)
        finally:
            k3.approx_matmul = call
        rows = ours[:SLICE_ROWS]
        plain = k3.approx_matmul_plain(a[:SLICE_ROWS], b, bias_a, bias_b, bias_r, **kw)
        err = (rows - plain).abs()
        record["calls"] += 1
        record["worst"] = max(record["worst"], float(err.max()))
        if torch.equal(rows, plain):
            record["equal"] += 1
        else:
            table = get_error_table(kw["expo_width"], kw["mant_width"], kw["with_comp"],
                                    kw["dnsmp_factor"])
            terms = approx_products(
                a[:SLICE_ROWS], b, kw["expo_width"], kw["mant_width"], bias_a, bias_b, bias_r,
                table, **{f: kw[f] for f in ("with_approx", "with_s2nn2s_opt",
                                             "golden_clip_of", "quant_btw_mult_accu")})
            tol = a.shape[1] * 2.0 ** -24 * terms.abs().sum(dim=1)
            if not (bool((err <= tol).all()) and bool(torch.isfinite(rows).all())):
                raise SystemExit(f"K3 breaks its bound against the plain version on a model "
                                 f"call {tuple(a.shape)} @ {tuple(b.shape)}")
        return ours

    k3.approx_matmul = call
    try:
        yield record
    finally:
        k3.approx_matmul = kernel


def k3_forward_bound(sm_clock_hz, dev):
    """K3's bound over the 74 products of a batch-8 ViT-B/16 forward (phase
    3's: the largest of the bytes over HBM bandwidth, one table read a
    product and one f32 add a product): (bound ms, bytes, products)."""
    table_reads_per_s = (torch.cuda.get_device_properties(dev).multi_processor_count
                         * SHARED_WORDS_PER_SM_CLOCK * sm_clock_hz)
    nbytes = sum(c * 4 * (m * k + k * n + m * n + n + 2) for _, m, k, n, c in layer_shapes(BATCH))
    products = sum(c * m * k * n for _, m, k, n, c in layer_shapes(BATCH))
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, products / table_reads_per_s,
                         products / F32_ADDS_PER_S)
    return bound_ms, nbytes, products


def traced_k3(qm, x, qp, sm_clock_hz, dev, log_dir):
    """One forward under ``utils/profiling.trace``: K3's kernel events in the
    trace it writes, their device ms, and ``roofline`` of that time beside
    K3's bound; the device launches of every kind and the forward's wall ms
    (the trace's host cost included). Returns a summary."""
    import os

    from fp8_quantization_tpu_torch.utils import profiling

    with torch.no_grad(), profiling.trace(log_dir):
        t0 = time.perf_counter()
        qm(x, qp=qp)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k3_events = [e for e in kernels if K3_KERNEL_NAME in e.get("name", "")]
    device_ms = sum(float(e["dur"]) for e in k3_events) / 1e3
    if not device_ms:
        raise SystemExit("the trace holds no K3 kernel time")
    bound_ms, nbytes, products = k3_forward_bound(sm_clock_hz, dev)
    peaks = profiling.device_peaks()
    roof = profiling.roofline(device_ms / 1e3, flops=2.0 * products, bytes_accessed=nbytes)
    return {"events": len(k3_events), "ms": device_ms, "bound_ms": bound_ms,
            "bound_share": bound_ms / device_ms, "peaks": peaks, "roofline": roof,
            "launches": len(kernels), "wall_ms": wall_ms,
            "busy_share": sum(float(e["dur"]) for e in kernels) / 1e3 / wall_ms}


def run_foreign_vit(cli, counters, dev, sm_clock_hz):
    """The foreign ViT-B/16 at full width, quantized by interception
    (``models.flax_surgery.quantize_flax_model``) under the
    ``scripts/image_net.sh`` flags with the approximate multiplier:
    calibrated on one batch of 8 synthetic images, run on two (K3 74 times
    a forward, K1/K2/K4 never); every K3 call of one forward held to its
    plain version on its own operands; one intercepted layer bit-equal to a
    port ``QuantDense`` holding its kernel and site state; the FP32 phase
    bit-equal to the foreign model; a ``filter_fn`` without the patch conv
    and the classifier (K3 72 times); a traced forward (74 K3 events,
    ``roofline`` against K3's bound); depth 2, batch 1, through K3 and its
    plain version. Returns its summary."""
    import shutil
    import tempfile

    from fp8_quantization_tpu_torch.models import quantize_flax_model
    from fp8_quantization_tpu_torch.models.vit import VIT_B_16
    from fp8_quantization_tpu_torch.ops.layers import QuantDense
    from fp8_quantization_tpu_torch.quant.sites import ESTIMATE, FIXED, FP32

    t0 = time.perf_counter()
    spec = VIT_B_16
    approx_qc, pub_qc = flags_qc(cli, APPROX_FLAGS), flags_qc(cli, PUBLISHED_FLAGS)
    foreign = foreign_vit(spec, dev)
    calib, *evals = foreign_images(spec, 1 + FOREIGN_EVALS, BATCH, 10, dev)
    qm = quantize_flax_model(foreign, approx_qc)
    out = {}
    with torch.no_grad():
        zero_counts(counters)
        qm(calib, qp=ESTIMATE)
        torch.cuda.synchronize()
        t_eval = time.perf_counter()
        logits = [qm(x, qp=FIXED) for x in evals]
        torch.cuda.synchronize()
        out["ms_per_img"] = 1e3 * (time.perf_counter() - t_eval) / (FOREIGN_EVALS * BATCH)
        out["counts"] = counts = read_counts(counters)
    expected = FOREIGN_K3_PER_FORWARD * (1 + FOREIGN_EVALS)
    ok = (counts["K3"] == expected and not any(v for k, v in counts.items() if k != "K3")
          and all(tuple(y.shape) == (BATCH, spec.num_classes) and bool(torch.isfinite(y).all())
                  for y in logits))
    phase("foreign", f"ViT-B/16 (plain PyTorch, HF names, seeded) by interception, approx "
                     f"E3M4: 1 calibration + {FOREIGN_EVALS} eval batches of {BATCH}, "
                     f"{out['ms_per_img']:.2f} ms/img (eval), launches {counts} (K3 expected "
                     f"{expected}, the others 0), finite logits {ok}")
    if not ok:
        raise SystemExit("foreign ViT-B/16: wrong launch counts or bad logits")

    # every K3 call of one forward on its own operands; layer 0's
    # intermediate dense (1576 x 768 x 3072) against a port QuantDense
    seen = []
    layer = qm.model.vit.encoder.layer[0].intermediate.dense
    hook = layer.register_forward_hook(lambda mod, args, y: seen.append((args[0], y)))
    with torch.no_grad(), verified_k3({}) as record:
        qm(evals[0], qp=FIXED)
    hook.remove()
    (x_in, y_layer), = seen
    dense = QuantDense(approx_qc, spec.hidden_size, spec.mlp_dim, device=dev)
    dense.load_state_dict({"kernel": layer.weight.t(), "bias": layer.bias,
                           **{k: v for k, v in layer.state_dict().items()
                              if "quantizer" in k or k.startswith("w_")}}, strict=True)
    with torch.no_grad():
        y_dense = dense(x_in, FIXED)
    parity = torch.equal(y_dense, y_layer)
    out["k3_verified"] = record
    phase("foreign", f"every K3 call of one forward against its plain version on "
                     f"{SLICE_ROWS} rows of its own operands: {record['calls']} calls, "
                     f"{record['equal']} bit-equal, max|d| {record['worst']:.3g}; layer 0's "
                     f"intermediate.dense {tuple(x_in.shape)} x {tuple(layer.weight.shape)} "
                     f"against a port QuantDense with its kernel and site state: bit-equal "
                     f"{parity}")
    if record["calls"] != FOREIGN_K3_PER_FORWARD or not parity:
        raise SystemExit("foreign ViT-B/16: K3 calls or the per-layer parity failed")

    # the FP32 phase (the published flags: no special run method) and the
    # filter_fn
    with torch.no_grad():
        fp32 = quantize_flax_model(foreign, pub_qc)
        fp32_equal = torch.equal(fp32(evals[0], qp=FP32), foreign(evals[0]))
        filtered = quantize_flax_model(
            foreign, approx_qc, filter_fn=lambda path, mod: path not in FOREIGN_UNFILTERED)
        filtered(calib, qp=ESTIMATE)
        zero_counts(counters)
        filtered(evals[0], qp=FIXED)
        torch.cuda.synchronize()
        out["filtered_counts"] = filtered_counts = read_counts(counters)
    del fp32, filtered
    phase("foreign", f"FP32 phase bit-equal to the foreign model {fp32_equal}; filter_fn "
                     f"without {' and '.join(FOREIGN_UNFILTERED)}: launches a forward "
                     f"{filtered_counts} (K3 expected {FOREIGN_K3_PER_FORWARD - 2})")
    if not fp32_equal or filtered_counts["K3"] != FOREIGN_K3_PER_FORWARD - 2:
        raise SystemExit("foreign ViT-B/16: the FP32 phase or the filter_fn failed")

    # one forward traced by utils/profiling
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        zero_counts(counters)
        out["trace"] = tr = traced_k3(qm, evals[0], FIXED, sm_clock_hz, dev, log_dir)
        traced_counts = read_counts(counters)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    roof = tr["roofline"]
    phase("foreign", f"utils/profiling.trace of one forward: {tr['events']} K3 kernel events "
                     f"(launches {traced_counts['K3']}), K3 {tr['ms']:.3f} device ms a forward "
                     f"(the port's QuantizedViT: {PORT_VIT_K3_MS} ms, PERF.md), bound "
                     f"{tr['bound_ms']:.3f} ms (share {tr['bound_share']:.4f}); device_peaks "
                     f"{tr['peaks']}; roofline: {roof['gbps']:.1f} GB/s "
                     f"({roof['bw_fraction_of_peak']:.4f} of peak), 2 x products at "
                     f"{roof['tflops']:.2f} TFLOP/s ({roof['flops_fraction_of_peak']:.4f} of the "
                     f"bf16 peak); device launches of every kind {tr['launches']}, busy share "
                     f"{tr['busy_share']:.3f} of {tr['wall_ms']:.1f} ms (traced)")
    if (tr["events"] != FOREIGN_K3_PER_FORWARD or traced_counts["K3"] != FOREIGN_K3_PER_FORWARD
            or any(v != v for v in tr["peaks"].values()) or tr["bound_share"] > 1.0
            or roof["bw_fraction_of_peak"] > 1.0):
        raise SystemExit("foreign ViT-B/16: the trace, the peaks or the roofline is wrong")
    del qm, foreign, logits
    torch.cuda.empty_cache()

    # depth 2, batch 1: the logits through K3 and through its plain version
    depth2 = dataclasses.replace(spec, num_layers=2)
    qm2 = quantize_flax_model(foreign_vit(depth2, dev), approx_qc)
    (x1,) = foreign_images(depth2, 1, 1, 3, dev)
    with torch.no_grad():
        qm2(x1, qp=ESTIMATE)
        logits = qm2(x1, qp=FIXED)
        with plain_kernels():
            plain_logits = qm2(x1, qp=FIXED)
    compare_logits("foreign ViT approx FIXED by interception", logits, plain_logits, depth2)
    del qm2
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


# an R3D-style block: 3x3x3 64 -> 64 SAME on 2 x 8 x 28 x 28 x 64
# channels-last (12,544 patch rows x 1,728), and a 2x2x2 stride-2 transposed
# conv 64 -> 32; the int8 sums on the input cropped to 4 x 10 x 10 (the CPU
# sums int32 without BLAS)
R3_INPUT = (2, 8, 28, 28, 64)
R3_CROP = (slice(None), slice(0, 4), slice(0, 10), slice(0, 10))
# K1 launches a forward of one rank-3 layer in the serving phases: its input
# and res sites (per-channel weights take none)
R3_K1_PER_FORWARD = 2


def rank3_layers(qc, dev, seed=31):
    from fp8_quantization_tpu_torch.ops.layers import QuantConv, QuantConvTranspose

    gen = torch.Generator().manual_seed(seed)
    conv = QuantConv(qc, 64, 64, kernel_size=(3, 3, 3), padding="SAME", generator=gen)
    convt = QuantConvTranspose(qc, 64, 32, kernel_size=(2, 2, 2), strides=(2, 2, 2),
                               padding="SAME", generator=gen)
    with torch.no_grad():
        for m in (conv, convt):
            m.bias.normal_(0.0, 0.1, generator=gen)
    return {"conv3d": conv.to(dev), "convT3d": convt.to(dev)}


def check_rank3(cli, counters, dev):
    """Rank-3 ``QuantConv`` / ``QuantConvTranspose`` at an R3D-style block's
    shapes: approx (K3 on the patches, every call held to its plain version
    on a 64-row slice), ``--fast-mode`` / packed / FP8 chained (K1 as the
    sites imply), the int8 conv sums against the CPU's (the zero point's code
    0 and -128), and the FIXED outputs against the same layers on the CPU.
    Returns its summary."""
    import copy

    from fp8_quantization_tpu_torch.eval.driver import cache_quantized_weights
    from fp8_quantization_tpu_torch.ops import fastpath
    from fp8_quantization_tpu_torch.ops.fastpath import int8_conv_sums
    from fp8_quantization_tpu_torch.quant.sites import CHAINED, ESTIMATE, FAST, FIXED, PACKED

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(37)
    x = torch.randn(R3_INPUT, generator=gen).to(dev)
    out = {"k3": {}, "k1": {}}
    approx_qc, pub_qc = flags_qc(cli, APPROX_FLAGS), flags_qc(cli, PUBLISHED_FLAGS)
    with torch.no_grad():
        for name, layer in rank3_layers(approx_qc, dev).items():
            layer(x, ESTIMATE)
            zero_counts(counters)
            with verified_k3({}) as record:
                y = layer(x, FIXED)
            torch.cuda.synchronize()
            counts = read_counts(counters)
            ms = cuda_ms(lambda: layer(x, FIXED), 3)
            out["k3"][name] = dict(record, launches=counts["K3"], ms=ms)
            phase("rank3", f"{name} approx FIXED {tuple(x.shape)} -> {tuple(y.shape)}: K3 "
                           f"launches {counts['K3']}, on {SLICE_ROWS} rows of its patches "
                           f"bit-equal {record['equal']} of {record['calls']} (max|d| "
                           f"{record['worst']:.3g}), {ms:.3f} ms a forward")
            if counts["K3"] != 1 or record["calls"] != 1 or not bool(torch.isfinite(y).all()):
                raise SystemExit(f"rank-3 {name}: K3 not launched once or bad output")
        del layer
        for name, layer in rank3_layers(pub_qc, dev).items():
            layer(x, ESTIMATE)
            cpu = copy.deepcopy(layer).cpu()
            ours, ref = layer(x, FIXED), cpu(x.cpu(), FIXED).to(dev)
            rms, equal = rel_rms(ours, ref), float((ours == ref).float().mean())
            cache_quantized_weights(layer, x, fast=True)
            fastpath.pack_dense_caches(layer, pub_qc)
            k1 = {}
            for qp_name, qp in (("FAST", FAST), ("PACKED", PACKED), ("CHAINED", CHAINED)):
                zero_counts(counters)
                served = layer(x, qp)
                torch.cuda.synchronize()
                k1[qp_name] = read_counts(counters)
                # K1 is bit-exact: the same layer through its plain version
                # gives the same output bit for bit
                with plain_kernels():
                    plain = layer(x, qp)
                if not bool(torch.isfinite(served.float()).all()):
                    raise SystemExit(f"rank-3 {name} {qp_name}: non-finite output")
                if not torch.equal(served, plain):
                    raise SystemExit(f"rank-3 {name} {qp_name}: the output through K1 differs "
                                     f"from the plain version's (max|d| "
                                     f"{float((served.float() - plain.float()).abs().max()):.3g})")
            out["k1"][name] = {k: c["K1"] for k, c in k1.items()}
            phase("rank3", f"{name} published FIXED on the card against the CPU: relative RMS "
                           f"{rms:.4g} (limit {RMS_LIMIT}), equal fraction {equal:.6f}; launches "
                           f"FAST / PACKED / CHAINED {k1} (K1 expected {R3_K1_PER_FORWARD} "
                           "each, no other kernel); each output bit-equal to the same layer "
                           "through the plain versions")
            if rms > RMS_LIMIT or any(
                    c["K1"] != R3_K1_PER_FORWARD or any(v for k, v in c.items() if k != "K1")
                    for c in k1.values()):
                raise SystemExit(f"rank-3 {name}: FIXED off the CPU's or wrong K1 launches")
        del layer, cpu
    # the int8 sums of both layers' shapes, the input cropped
    codes = torch.randint(-128, 128, R3_INPUT, generator=gen, dtype=torch.int8)[R3_CROP]
    codes[0, 0, 0] = -128
    cases = {"conv3d": (torch.randint(-127, 128, (3, 3, 3, 64, 64), generator=gen,
                                      dtype=torch.int8),
                        dict(strides=(1, 1, 1), padding="SAME", dilation=(1, 1, 1))),
             "convT3d": (torch.randint(-127, 128, (2, 2, 2, 64, 32), generator=gen,
                                       dtype=torch.int8),
                         dict(strides=(1, 1, 1), dilation=(1, 1, 1), input_dilation=(2, 2, 2),
                              padding=((1, 1),) * 3))}
    for name, (w, kw) in cases.items():
        for cx in (0.0, -128.0):
            ours = int8_conv_sums(codes.to(dev), w.to(dev), torch.tensor(cx, device=dev),
                                  with_xsum=True, **kw)
            cpu = int8_conv_sums(codes, w, torch.tensor(cx), with_xsum=True, **kw)
            if not (torch.equal(ours[0].cpu(), cpu[0]) and torch.equal(ours[1].cpu(), cpu[1])):
                raise SystemExit(f"rank-3 int8 {name} sums on the card differ from the CPU's, "
                                 f"cx {cx}")
    phase("rank3", f"int8 sums of the 3x3x3 conv and the 2x2x2 stride-2 transposed conv on "
                   f"{tuple(codes.shape)} codes, cx 0 and -128: equal to the CPU int32 path")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def check_grids_on_card(dev):
    """``python -m fp8_quantization_tpu_torch.fp8_grid_check`` on the card:
    every grid a fixed point of the port's ``quantize_to_fp8_ste``."""
    import io

    from fp8_quantization_tpu_torch import fp8_grid_check

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = fp8_grid_check.check_grids(dev)
    lines = [ln.strip() for ln in buf.getvalue().splitlines() if "idempotent" in ln]
    phase("grids", f"fp8_grid_check on the card: {'; '.join(lines)}")
    if not ok:
        raise SystemExit("fp8_grid_check: a grid is not a fixed point on the card")


def run_slice17(cli, counters, dev, sm_clock_hz):
    """The interception, rank-3 and grid phases, with their wall seconds."""
    t0 = time.perf_counter()
    foreign = run_foreign_vit(cli, counters, dev, sm_clock_hz)
    rank3 = check_rank3(cli, counters, dev)
    check_grids_on_card(dev)
    seconds = time.perf_counter() - t0
    phase("foreign", f"the interception, rank-3 and grid phases took {seconds:.1f} s "
                     f"(foreign ViT {foreign['seconds']:.1f} s, rank 3 {rank3['seconds']:.1f} s)")
    return {"foreign": foreign, "rank3": rank3, "seconds": seconds}


# ---------------------------------------------------------------------------
# The mesh (slice 18): ``parallel/`` over virtual meshes that repeat cuda:0.
# K4 and K5 run per (data, model) cell on their code shards inside
# ``partitioned_kernels``; ring attention runs the sequence over ``data``.

# phase 3: Llama-3-8B's projection (K, N): k/v, q/o, gate/up, down, lm_head,
# at a decode step's 4 rows (2 a data shard) and a k = 4 verify's 20 (10 a
# shard: route A, where the whole call takes route B); 40 rows (20 a shard,
# route B on both sides) at the first two
MESH_SHAPES = ((4096, 1024), (4096, 4096), (4096, 14336), (14336, 4096), (4096, 128256))
MESH_ROWS = (4, 20)
MESH_ROUTE_B_ROWS = 40
MESH_NEW_TOKENS = 8
RING_TOKENS = 512
RING_DATA = 4
# phase 5's paged speculative run over a (2, 4) mesh: eight slots, so that
# a k = 4 verify's 40 rows keep route B on 20 a shard, and prompts whose
# padded chunks (112 cold, 48 warm) keep route B on half their rows
MESH_SLOTS = 8
MESH_SHARED = 64
MESH_TAILS = (33, 40, 45, 47)


def virtual_mesh(dev, data, model):
    """A (data, model) mesh whose every cell is ``dev``."""
    from fp8_quantization_tpu_torch.parallel import make_mesh

    return make_mesh(data=data, model=model, devices=[dev] * (data * model))


def partitioned_call(mesh, fn, wrapper):
    """``fn()`` inside ``partitioned_kernels(mesh)``; returns its result, the
    launches it added to ``wrapper`` and ``shard_kernels.CALLS``."""
    from fp8_quantization_tpu_torch.parallel import shard_kernels as sk

    sk.reset_calls()
    before = wrapper.launches
    with sk.partitioned_kernels(mesh):
        out = fn()
    return out, wrapper.launches - before, dict(sk.CALLS)


def check_sharded_kernels(fm, dm, dev):
    """Phase 3: K4 (bf16 and coded x) and K5 partitioned over a virtual
    (2, 4) mesh at ``MESH_SHAPES``, the codes placed by ``shard_variables``:
    each call launches its kernel once per cell (8) on the (rows / 2, K, N /
    4) shard, and its gathered result holds against the plain version (bit
    for bit where a shard takes route A, and for K5; within
    ``within_requant_step`` on route B) and against the unsharded kernel
    (equal where both take one route). At M = 4 the sharded and unsharded
    calls are timed (CUDA events; the sharded one's host work, 8 launches
    and 8 gather copies, is queued behind the device sleep as well).
    Returns the worst |d| against the plain versions and the timings."""
    from fp8_quantization_tpu_torch.numerics.codec import pack_exmy, unpack_exmy
    from fp8_quantization_tpu_torch.parallel import shard_kernels as sk
    from fp8_quantization_tpu_torch.parallel import shard_variables

    t0 = time.perf_counter()
    mesh = virtual_mesh(dev, 2, 4)
    gen = torch.Generator(device=dev).manual_seed(18)
    act = device_qscalars(dev, 4.0, 4, 4, 1)
    x_bias = torch.tensor(3, dtype=torch.int32, device=dev)
    worst = {"K4": 0.0, "K5": 0.0}
    timings = {}
    for k, n in MESH_SHAPES:
        rows = MESH_ROWS + ((MESH_ROUTE_B_ROWS,) if (k, n) in MESH_SHAPES[:2] else ())
        x, wq, bias = gemm_operands(max(rows), k, n, dev, seed=k + n + 18)
        pw = dm.pack_weights(wq, bias, 3, 4)
        del wq
        w_eff = dm.unpack_weights(pw)
        xq = fm.quantize_block_plain(x, *act)
        x_codes = pack_exmy(xq, 3, 4, x_bias, clip_of=True)
        x8, w4, _ = int4_operands(gen, max(rows), k, n, dev)
        shard_variables({"w_codes": pw.codes, "w_pack_bias": pw.bias, "w_i4": w4}, mesh)
        for m in rows:
            shard_route, whole_route = fm.gemm_route(m // 2), fm.gemm_route(m)
            forms = (("bf16 x", xq[:m].to(torch.bfloat16), {}, xq[:m]),
                     ("coded x", x_codes[:m], dict(x_bias=x_bias, x_expo=3, x_mant=4),
                      unpack_exmy(x_codes[:m], 3, 4, x_bias)))
            for what, xin, xkw, x_eff in forms:
                kw = dict(expo_width=3, mant_width=4, **xkw)
                plain = dm.dequant_matmul_plain(xin, pw.codes, pw.bias, **kw)
                whole = dm.dequant_matmul(xin, pw.codes, pw.bias, **kw)
                ours, launches, calls = partitioned_call(
                    mesh, lambda: sk.sharded_dequant_matmul(xin, pw.codes, pw.bias, **kw),
                    dm.dequant_matmul)
                if shard_route == "A":
                    ok_plain = torch.equal(ours, plain)
                else:
                    ok_plain = fm.within_requant_step(ours, plain,
                                                      fm.sum_tolerance(x_eff, w_eff))[0]
                ok_whole = (torch.equal(ours, whole) if shard_route == whole_route
                            else gemm_verdict(fm, whole, plain, x_eff, w_eff, None, plain)[1])
                worst["K4"] = max(worst["K4"], float((ours - plain).abs().max()))
                if not (ok_plain and ok_whole and launches == 8
                        and calls == {"partitioned": 1, "unsharded": 0, "split_on_call": 0}):
                    raise SystemExit(f"sharded K4 {m}x{k}x{n} {what}: against plain {ok_plain}, "
                                     f"against the unsharded kernel {ok_whole}, launches "
                                     f"{launches}, calls {calls}")
            xin = x8[:m]
            plain = dm.int4_matmul_plain(xin, w4, k=k)
            ours, launches, calls = partitioned_call(
                mesh, lambda: sk.sharded_int4_matmul(xin, w4, k=k), dm.int4_matmul)
            if not (torch.equal(ours, plain) and torch.equal(ours, dm.int4_matmul(xin, w4, k=k))
                    and launches == 8 and calls["partitioned"] == 1):
                raise SystemExit(f"sharded K5 {m}x{k}x{n}: differs from its plain version or "
                                 f"the unsharded kernel, or launches {launches}, calls {calls}")
            if m == MESH_ROWS[0]:
                xb = xq[:m].to(torch.bfloat16)
                timings[(k, n)] = {
                    "K4": cuda_ms(lambda: dm.dequant_matmul(xb, pw.codes, pw.bias, expo_width=3,
                                                            mant_width=4), 3, SHORT_HEAD_START),
                    "K4 sharded": cuda_ms(lambda: partitioned_call(
                        mesh, lambda: sk.sharded_dequant_matmul(
                            xb, pw.codes, pw.bias, expo_width=3, mant_width=4),
                        dm.dequant_matmul), 3, SHORT_HEAD_START),
                    "K5": cuda_ms(lambda: dm.int4_matmul(xin, w4, k=k), 3, SHORT_HEAD_START),
                    "K5 sharded": cuda_ms(lambda: partitioned_call(
                        mesh, lambda: sk.sharded_int4_matmul(xin, w4, k=k), dm.int4_matmul),
                        3, SHORT_HEAD_START)}
            phase("kernels", f"sharded K4 (bf16 and coded x) and K5 at {m}x{k}x{n} over (2, 4): "
                             f"8 launches a call on {m // 2}x{k}x{n // 4} shards, route "
                             f"{shard_route} a shard ({whole_route} whole); "
                             + ("K4 equal to plain" if shard_route == "A" else
                                "K4 within the route B contract")
                             + (", equal to the unsharded kernel" if shard_route == whole_route
                                else ", the unsharded call within its own contract")
                             + "; K5 equal to plain and to the unsharded kernel"
                             + ("; ms at M = 4: " + ", ".join(
                                 f"{key} {v:.4f}" for key, v in timings[(k, n)].items())
                                if m == MESH_ROWS[0] else ""))
        del x, xq, x_codes, x8, w4, pw, w_eff, plain, whole, ours
        torch.cuda.empty_cache()
    phase("kernels", f"the sharded K4/K5 checks took {time.perf_counter() - t0:.1f} s")
    return worst, timings


@contextlib.contextmanager
def plain_where_shards_change_route(data):
    """The layers' K4 calls through K4's plain version where their rows
    divide over ``data`` and take another route whole than a shard's share
    takes (17 to 32 rows over two: route B whole, route A a shard, and route
    A is bit for bit the plain version), and through
    ``sharded_dequant_matmul`` (so the counted kernel) elsewhere. Yields the
    count of the diverted calls (no launch), by kernel."""
    from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as dm
    from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as fm
    from fp8_quantization_tpu_torch.parallel import shard_kernels as sk

    wrapper = sk.sharded_dequant_matmul
    diverted = {"K4": 0}

    def chosen(x2d, codes, bias, **kw):
        m = x2d.shape[0]
        if m % data == 0 and fm.gemm_route(m) != fm.gemm_route(m // data):
            diverted["K4"] += 1
            return dm.dequant_matmul_plain(x2d, codes, bias, **kw)
        return wrapper(x2d, codes, bias, **kw)

    sk.sharded_dequant_matmul = chosen
    try:
        yield diverted
    finally:
        sk.sharded_dequant_matmul = wrapper


def serve_mesh(name, model, spec, qp, counters, dev, per_forward, mesh, reference):
    """Phase 4: ``serve_llama``'s prompts for ``MESH_NEW_TOKENS`` tokens
    through a ``ContinuousBatcher`` over ``mesh``, its logit rows recorded.
    Placing the model (``reshard``) is timed and its memory read. Every
    product must run partitioned (``shard_kernels.CALLS``: none unsharded,
    no weight split at a call; every chunk and step here divides over
    ``data``, so each product launches its kernel once a cell: the dense
    kernel's ``per_forward`` times the mesh's size). Against ``reference``
    (the same prompts served without a mesh, recorded or not): the requests
    whose admission keeps its K2/K4 route on the shards' rows give its
    tokens (and logit rows) bit for bit. An admission of 17 to 32 rows
    takes route A on its 16 or fewer a shard where the whole call takes
    route B; such a request is held bit for bit (tokens and logit rows) to
    the same prompts served without a mesh with K4's plain version on
    exactly those calls (``plain_where_shards_change_route``), and where its
    tokens part from ``reference`` is printed."""
    from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher
    from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as fm
    from fp8_quantization_tpu_torch.parallel import shard_kernels as sk

    torch.cuda.synchronize()
    before_gb = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    batcher = ContinuousBatcher(model, spec, slots=LLAMA_SLOTS, max_seq=LLAMA_MAX_SEQ, qp=qp,
                                mesh=mesh)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    shards_gb = torch.cuda.memory_allocated(dev) / 1e9 - before_gb
    dense_key = next(key for key in per_forward if key != "K1")
    sk.reset_calls()
    run = serve_llama(name, model, spec, qp, counters, dev,
                      {**per_forward, dense_key: per_forward[dense_key] * mesh.size},
                      batcher=batcher, record=True, new_tokens=MESH_NEW_TOKENS)
    calls = dict(sk.CALLS)
    forwards = len(run["step_s"]) + len(run["chunks"])
    dense = llama_dense_per_forward(spec)
    data = mesh.shape["data"]
    changed = [i for i, c in enumerate(run["chunks"])
               if c % data == 0 and fm.gemm_route(c) != fm.gemm_route(c // data)]
    kept = [i for i in range(len(run["chunks"])) if i not in changed]
    ref_tokens = [t[:MESH_NEW_TOKENS] for t in reference["tokens"]]
    # a reference served unrecorded holds the tokens only
    ref_rows = [r[:MESH_NEW_TOKENS] for r in reference["rows"]] or None

    def equal(i, tokens, rows):
        return run["tokens"][i] == tokens[i] and (
            rows is None or rows_equal([run["rows"][i]], [rows[i]]))

    exact = all(equal(i, ref_tokens, ref_rows) for i in kept)
    switched, parted = None, {}
    if changed:
        with plain_where_shards_change_route(data) as diverted:
            switched = serve_llama(f"{name}, K4 plain where the shards take another route",
                                   model, spec, qp, counters, dev, per_forward, record=True,
                                   new_tokens=MESH_NEW_TOKENS, uncounted=diverted)
        switched["diverted"] = dict(diverted)
        exact = exact and diverted["K4"] == dense * len(changed) and all(
            equal(i, switched["tokens"], switched["rows"]) for i in range(len(run["chunks"])))
        parted = {i: next((j for j, (a, b) in enumerate(zip(run["tokens"][i], ref_tokens[i]))
                           if a != b), None) for i in changed}
    ok = (exact
          and calls == {"partitioned": dense * forwards, "unsharded": 0, "split_on_call": 0})
    run.update(calls=calls, place_s=place_s, shards_gb=shards_gb, exact=exact,
               changed_products=dense * len(changed), changed_requests=changed,
               parted_from_kernel_run=parted, mesh=dict(mesh.shape))
    phase("main", f"Llama-3-8B {name} over a virtual ({data}, {mesh.shape['model']}) mesh: "
                  f"placed in {place_s:.2f} s, shards {shards_gb:.2f} GB, peak "
                  f"{run['peak_gb']:.2f} GB; partitioned calls {calls} for {forwards} forwards; "
                  f"{dense * len(changed)} products took another route on their shards "
                  f"(requests {changed}); requests {kept} equal to the single-device run and "
                  + (f"all {len(run['chunks'])} equal to the single-device run with K4 plain on "
                     f"the {switched['diverted']['K4']} switched calls, " if changed else "")
                  + f"bit for bit (tokens and logit rows): {exact}"
                  + (f"; the switched requests part from the kernel run at token {parted}"
                     if changed else "") + f"; ok={ok}")
    if not ok:
        raise SystemExit(f"Llama {name} over the mesh: partitioned calls or tokens wrong")
    return run


def check_ring_prefill(model, spec, dev):
    """Phase 4: Llama-3-8B FAST (``fused_sdpa`` off: the einsum route)
    prefills one ``RING_TOKENS``-token prompt into an empty cache with
    ``ring_spec`` over a virtual ``(RING_DATA, 1)`` mesh and dense.

    In f32, as served: every ``ring_attention`` call holds against
    ``full_attention`` on its own inputs at JAX's ``rtol = atol = 2e-5``,
    and layer 0's K/V cache (written before any attention) is equal. Past
    layer 0 the two part. The ring folds its K/V blocks by an online
    softmax (another summation order), and it multiplies the scores by
    ``d ** -0.5``, as JAX's ring does, where the einsum divides them by the
    f32 ``sqrt(d)`` (another rounding of the scale). FP8 sites turn such
    one-ulp differences into grid steps at rounding midpoints, and 32 layers
    compound them. So the f32 logits are held below the reading of a
    lower-precision control taken in the same run, K7's dense prefill (bf16
    q, k and v) from the einsum: a relative RMS under that reading, and the
    same argmax where the einsum's top-1/top-2 margin is at least twice
    their max |d|.

    The witness, in f64: the ring's attention in f64 at the einsum's scale
    (``1 / sqrt_f32(d)``) against ``full_attention`` in f64 at that scale,
    in the same block, must meet JAX's bar for the ring prefill (its
    ``tests/test_ring_attention.py``): logits within ``rtol = atol =
    2e-4`` and every layer's K/V cache equal. In f64 the two summation
    orders differ far below an f32 rounding step, so what is left is what
    the ring computes. A third f64 run, the ring at its own ``d ** -0.5``,
    reads what the scale convention alone does to the logits."""
    from fp8_quantization_tpu_torch.models import llama as llama_mod
    from fp8_quantization_tpu_torch.models.llama import KVCache
    from fp8_quantization_tpu_torch.parallel.ring_attention import full_attention, ring_attention
    from fp8_quantization_tpu_torch.quant.sites import QuantPhase

    t0 = time.perf_counter()
    mesh = virtual_mesh(dev, RING_DATA, 1)
    einsum_qp = QuantPhase(phase="fixed", fast=True, fused_sdpa=False)
    tokens = torch.as_tensor(np.random.default_rng(18).integers(0, spec.vocab_size,
                                                                (1, RING_TOKENS)), device=dev)
    hd = spec.hidden_size // spec.num_heads
    einsum_scale = 1.0 / float(torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))
    ratios = []

    def held(q, k, v, mesh_, **kw):
        out = ring_attention(q, k, v, mesh_, **kw)
        ref = full_attention(q, k, v, causal=kw.get("causal", True))
        ratios.append(float(((out - ref).abs() / (2e-5 + 2e-5 * ref.abs())).max()))
        return out

    def ring64(scale):
        return lambda q, k, v, mesh_, **kw: ring_attention(
            q.double(), k.double(), v.double(), mesh_, scale=scale, **kw).float()

    def dense64(q, k, v, mesh_, *, causal, **_):
        return full_attention(q.double(), k.double(), v.double(), causal=causal,
                              scale=einsum_scale).float()

    def prefill(ring, qp=einsum_qp, attend=ring_attention):
        """Logits, cache and seconds of one prefill; with ``ring`` the
        blocks' ring branch runs ``attend``."""
        model.ring_spec = (mesh, "data") if ring else None
        llama_mod.ring_attention = attend
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                logits, cache = model(tokens, KVCache.zeros(spec, 1, RING_TOKENS, device=dev), qp)
            torch.cuda.synchronize()
            return logits[0].float(), cache, time.perf_counter() - t
        finally:
            model.ring_spec = None
            llama_mod.ring_attention = ring_attention

    def equal_layers(a, b):
        return sum(torch.equal(a.k[i], b.k[i]) and torch.equal(a.v[i], b.v[i])
                   for i in range(spec.num_layers))

    logits_r, cache_r, _ = prefill(True, attend=held)
    ring_s = prefill(True)[2]
    logits_d, cache_d, dense_s = prefill(False)
    logits_k7 = prefill(False, serving_phase(False))[0]
    logits_r64, cache_r64, _ = prefill(True, attend=ring64(einsum_scale))
    logits_d64, cache_d64, _ = prefill(True, attend=dense64)
    logits_own64 = prefill(True, attend=ring64(None))[0]
    diff = float((logits_r - logits_d).abs().max())
    rms, legal = rel_rms(logits_r, logits_d), rel_rms(logits_k7, logits_d)
    top2 = torch.topk(logits_d, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) >= 2 * diff
    same = bool(((logits_r.argmax(-1) == logits_d.argmax(-1)) | ~decided).all())
    within = float(torch.isclose(logits_r, logits_d, rtol=2e-4, atol=2e-4).float().mean())
    equal = [float((cache_r.k[i] == cache_d.k[i]).float().mean()) for i in range(spec.num_layers)]
    layer0 = torch.equal(cache_r.k[0], cache_d.k[0]) and torch.equal(cache_r.v[0], cache_d.v[0])
    witness = dict(
        max_diff=float((logits_r64 - logits_d64).abs().max()),
        within_2e4=bool(torch.isclose(logits_r64, logits_d64, rtol=2e-4, atol=2e-4).all()),
        cache_equal_layers=equal_layers(cache_r64, cache_d64),
        own_scale_rms=rel_rms(logits_own64, logits_d64),
        einsum_f32_rms=rel_rms(logits_d, logits_d64), ring_f32_rms=rel_rms(logits_r, logits_d64))
    ok = (len(ratios) == spec.num_layers and max(ratios) <= 1.0 and layer0 and rms < legal
          and same and bool(torch.isfinite(logits_r).all()) and witness["within_2e4"]
          and witness["cache_equal_layers"] == spec.num_layers)
    phase("main", f"Llama-3-8B ring prefill, {RING_TOKENS} tokens over a virtual ({RING_DATA}, 1) "
                  f"mesh: {len(ratios)} ring_attention calls within 2e-5 of full_attention on "
                  f"their own inputs (worst |d| / tol {max(ratios):.3g}); layer 0's K/V cache "
                  f"equal {layer0}; K cache equal fraction by layer "
                  f"{[round(e, 4) for e in equal[:4]]} ... {round(equal[-1], 4)}; logits max|d| "
                  f"{diff:.4g}, relative RMS {rms:.4g} (limit: K7's dense prefill from the "
                  f"einsum, {legal:.4g}), {within:.4f} of them within 2e-4, same argmax where "
                  f"decided {same} ({int(decided.sum())} of {decided.numel()} positions "
                  f"decided); f64 witness at the einsum's scale: ring against dense logits "
                  f"max|d| {witness['max_diff']:.4g}, all within 2e-4 {witness['within_2e4']}, "
                  f"K/V cache equal in {witness['cache_equal_layers']} of {spec.num_layers} "
                  f"layers; relative RMS from the f64 dense: the ring in f64 at d**-0.5 "
                  f"{witness['own_scale_rms']:.4g}, the f32 einsum {witness['einsum_f32_rms']:.4g}"
                  f", the f32 ring {witness['ring_f32_rms']:.4g}; ring {1e3 * ring_s:.1f} ms, "
                  f"dense einsum {1e3 * dense_s:.1f} ms; {time.perf_counter() - t0:.1f} s; ok={ok}")
    if not ok:
        raise SystemExit("Llama ring prefill: outside its contract")
    return dict(ring_ms=1e3 * ring_s, dense_ms=1e3 * dense_s, max_diff=diff, rms=rms,
                legal_rms=legal, within_2e4=within, cache_equal=equal, worst_ratio=max(ratios),
                f64=witness)


def mesh_prompts(spec):
    rng = np.random.default_rng(21)
    shared = rng.integers(0, spec.vocab_size, MESH_SHARED).tolist()
    return [shared + rng.integers(0, spec.vocab_size, n).tolist() for n in MESH_TAILS]


def check_mesh_batchers(dev, counters):
    """Phase 5: Llama-3-8B at full width and depth 2, packed (PACKED +
    packed_kv + fused): the paged batcher with a self-draft (k = 4) and a
    prefix cache over a virtual (2, 4) mesh, and ``SpeculativeDecoder``
    over (1, 8), each with the tokens of the same batcher without a mesh
    (every product keeps its route on its shards: ``MESH_SLOTS`` and
    ``mesh_prompts``); then ``parallel.dryrun.dryrun_multichip`` over eight
    cells of the card (tiny shapes through K4 and K5)."""
    from fp8_quantization_tpu_torch.models.llama import LLAMA3_8B
    from fp8_quantization_tpu_torch.models.prefix_cache import PrefixCache
    from fp8_quantization_tpu_torch.models.serving import pack_llama
    from fp8_quantization_tpu_torch.models.speculative import SpeculativeDecoder
    from fp8_quantization_tpu_torch.parallel import shard_kernels as sk
    from fp8_quantization_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    spec = dataclasses.replace(LLAMA3_8B, num_layers=2)
    model = calibrated_llama(spec, dev, seed=1)
    pack_llama(model)
    qp = serving_phase(True)
    prompts = mesh_prompts(spec)

    def serve(mesh):
        from fp8_quantization_tpu_torch.models.paged_kv import PagedBatcher

        pc = PrefixCache(max_tokens=4096, bucket=16)
        b = PagedBatcher(model, spec, slots=MESH_SLOTS, num_pages=LLAMA_PAGES,
                         page_size=LLAMA_PAGE, max_seq=LLAMA_MAX_SEQ, qp=qp, mesh=mesh,
                         prefix_cache=pc, draft_model=model, draft_spec=spec, spec_k=SPEC_K)
        zero_counts(counters)
        sk.reset_calls()
        slots = [b.admit(p, max_new_tokens=MESH_NEW_TOKENS) for p in prompts]
        b.run_to_completion()
        return ([b.retire(s) for s in slots], read_counts(counters), dict(sk.CALLS),
                (pc.hits, pc.misses), b.acceptance_rate)

    plain = serve(None)
    meshed = serve(virtual_mesh(dev, 2, 4))
    spec_plain = SpeculativeDecoder(model, spec, model, spec, k=SPEC_K, qp=qp).generate(
        prompts[0], MESH_NEW_TOKENS)[0]
    sk.reset_calls()
    spec_mesh = SpeculativeDecoder(model, spec, model, spec, k=SPEC_K, qp=qp,
                                   mesh=virtual_mesh(dev, 1, 8)).generate(
        prompts[0], MESH_NEW_TOKENS)[0]
    spec_calls = dict(sk.CALLS)
    dry = dryrun_multichip(8, [dev] * 8)
    ok = (meshed[0] == plain[0] and meshed[3] == plain[3] == (3, 1)
          and meshed[2]["unsharded"] == meshed[2]["split_on_call"] == 0
          and meshed[2]["partitioned"] > 0 and meshed[1]["K4"] > plain[1]["K4"]
          and spec_mesh == spec_plain and spec_calls["unsharded"] == 0
          and spec_calls["partitioned"] > 0)
    phase("model", f"Llama-3-8B width {spec.hidden_size}, depth 2, PACKED+packed_kv+fused over "
                   f"virtual meshes: the paged speculative batcher with a prefix cache "
                   f"({MESH_SLOTS} slots, k = {SPEC_K}, hits/misses {meshed[3]}, acceptance "
                   f"{meshed[4]:.3f}) over (2, 4) gives the tokens without a mesh "
                   f"{meshed[0] == plain[0]} ({meshed[0][0][:4]}...), partitioned calls "
                   f"{meshed[2]}, launches {meshed[1]} (without a mesh {plain[1]}); "
                   f"SpeculativeDecoder over (1, 8) gives them {spec_mesh == spec_plain} "
                   f"(calls {spec_calls}); dry run over eight cells {dry}; "
                   f"{time.perf_counter() - t0:.1f} s; ok={ok}")
    if not ok:
        raise SystemExit("the mesh batchers at depth 2: tokens or partitioned calls wrong")
    del model
    torch.cuda.empty_cache()
    return dict(paged_calls=meshed[2], paged_launches=meshed[1], spec_calls=spec_calls,
                seconds=time.perf_counter() - t0)


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
    width_err = check_widths(fm, dm, dev)
    for key in width_err:
        gemm_err[key] = max(gemm_err[key], width_err[key])
    attention_err, k7_vit = check_attention(LLAMA3_8B, dev)
    gemm_err.update(attention_err)
    check_k5(dm, dev)
    mesh_err, mesh_times = check_sharded_kernels(fm, dm, dev)
    gemm_err["K4"] = max(gemm_err["K4"], mesh_err["K4"])
    cnn_err, k3_cnn = check_k3_cnn(k3, dev, 1e6 * sm_clock_mhz)
    max_err = max(max_err, cnn_err)
    int8_conv = check_int8_conv(dev)
    # the surgery model's and the demo's shapes
    t_surgery = time.perf_counter()
    surgery_err, k3_surgery = check_k3_surgery(k3, dev, 1e6 * sm_clock_mhz)
    max_err = max(max_err, surgery_err)
    surgery_gemm_err = check_gemms(fm, dm, dev, SURGERY_GEMM_SHAPES)
    for key in surgery_gemm_err:
        gemm_err[key] = max(gemm_err[key], surgery_gemm_err[key])
    check_int8_transpose(dev)
    surgery_kernels_s = time.perf_counter() - t_surgery
    # BERT-base's shapes: the 4096-row products, the pooler, the 2-wide classifier
    t_bert = time.perf_counter()
    bert_gemm_err = check_gemms(fm, dm, dev, BERT_GEMM_SHAPES)
    for key in bert_gemm_err:
        gemm_err[key] = max(gemm_err[key], bert_gemm_err[key])
    bert_s = time.perf_counter() - t_bert

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
    # the MSE range setting with the mantissa-width election, and the run
    # methods simulated in plain PyTorch
    t_mse = time.perf_counter()
    mse = {name: run_mse(cli, counters, name) for name in MSE_RUNS}
    k3_oracle_logits = run_k3_oracle_batch(cli, counters)
    special = {"qama": run_special(cli, counters, "qama", QAMA_FLAGS, None),
               "OF/UF oracle": run_special(cli, counters, "OF/UF oracle", OFUF_FLAGS,
                                           k3_oracle_logits)}
    mse_s = time.perf_counter() - t_mse
    # MobileNetV2 and ResNet-18/50 at full width, batch 16, and ViT-B/16's
    # uniform serving at the same batch
    t_cnn = time.perf_counter()
    cnn = {f"{arch} {mode}": run_cnn(cli, counters, arch, mode) for arch, mode in CNN_RUNS}
    cnn_s = time.perf_counter() - t_cnn
    # the demo, the surgery model, --model-dir, checkpoints and --images-dir
    surgery_io = run_weights_and_surgery(cli, counters, dev)
    # BERT-base: the nlp entry point three ways and the serving modes
    bert = run_bert(dev, counters)
    bert_s += bert["seconds"]
    # train-qat on MobileNetV2 at full width: no kernel on its path
    qat = run_qat(cli, counters, dev)
    # a foreign ViT-B/16 quantized by interception (K3), rank-3 convs (K3,
    # K1), profiling and the grid check
    slice17 = run_slice17(cli, counters, dev, 1e6 * sm_clock_mhz)

    # K1, K2 and K4 checked and timed at the shapes of one batch-8 forward
    times = time_serving_kernels(fm, dm, dev, gemm_err)
    times["K3"] = k3_times
    # K2 and K4 at the shapes of one BERT-base forward at 32 x 128
    t0 = time.perf_counter()
    bert_gemms = time_dense_gemms(fm, dm, dev, gemm_err, bert_dense_shapes(), coded=False)
    bert_s += time.perf_counter() - t0

    # Llama-3-8B served by ContinuousBatcher; K7 and K6 checked and timed at
    # the shapes each run gave them
    llama_spec, llama, prefix_spec, paged, mesh = run_llama_serving(dev, counters)
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
    mse_model = check_mse_model(cli, dev, depth2, counters)
    mse_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    check_cnn_models(cli, dev, counters)
    check_cnn_serving(cli, dev, counters)
    cnn_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    check_bert_models(dev, counters)
    bert_s += time.perf_counter() - t0
    phase("bert", f"the BERT-base kernel checks, timings, runs and model checks took "
                  f"{bert_s:.1f} s in all")
    check_llama_model(dev, counters)
    check_llama_uniform(dev, counters)
    mesh_model = check_mesh_batchers(dev, counters)

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
        # the Llama-3-8B prefix and speculative runs of phase 4 (launches per run)
        **({"prefix_spec_launches": {run: r["counts"][key] for run, r in prefix_spec.items()
                                     if r["counts"][key]}}
           if key in ("K1", "K2", "K4", "K6", "K7") else {}),
        # the MSE runs of phase 4 (launches per run: K1/K2 at the elected
        # widths, K4 on the layers whose elected width packs)
        **({"mse_launches": {run: r["counts"][key] for run, r in mse.items()}}
           if key in ("K1", "K2", "K4") else {}),
        # the paged runs of phase 4 and their dense einsum-route references
        # (launches per run; no K6 on a paged target decode)
        **({"paged_launches": {run: r["counts"][key] for run, r in paged.items()}}
           if key in ("K1", "K2", "K4", "K6", "K7") else {}),
        # the weights, images, demo and surgery runs of phase 4 (launches per
        # run) and K3 per batch-16
        # forward of the surgery model
        **({"surgery_io_launches": {
            **{f"demo {m}": r[2][key] for m, r in surgery_io["demo"].items()},
            **{f"surgery {m}": r[2][key] for m, r in surgery_io["surgery"].items()},
            **{f"--model-dir {run}": r["counts"][key]
               for run, r in surgery_io["model_dir"].items()},
            "checkpoint restore": surgery_io["checkpoint"]["counts"][key]}}
           if key in ("K1", "K2", "K3", "K4") else {}),
        **({"per_surgery_forward": {f: k3_surgery[f] for f in ("launches", "ms", "plain_ms",
                                                                "bound_ms", "bound_by")}}
           if key == "K3" else {}),
        # the foreign ViT-B/16 by interception (launches per run: 1
        # calibration and 2 eval batches; per forward with the filter_fn and
        # traced, with the traced forward's device ms) and the rank-3 layers
        # (launches per forward)
        **({"foreign_vit_launches": {
            "approx run": slice17["foreign"]["counts"][key],
            "filter_fn forward": slice17["foreign"]["filtered_counts"][key],
            "traced forward": slice17["foreign"]["trace"]["events"]},
            "per_foreign_vit_forward": {f: slice17["foreign"]["trace"][f]
                                        for f in ("ms", "bound_ms")},
            "rank3_launches": {f"{name} approx": r["launches"]
                               for name, r in slice17["rank3"]["k3"].items()}}
           if key == "K3" else {}),
        **({"rank3_launches": {f"{name} {mode}": n for name, r in slice17["rank3"]["k1"].items()
                               for mode, n in r.items()}} if key == "K1" else {}),
        # the train-qat runs of phase 4 and the QAT ladder: no launch
        "qat_launches": {run: r["counts"][key] for run, r in qat["runs"].items()},
        # the BERT-base runs of phase 4 (launches per nlp run and per serving
        # forward at 32 x 128) and K2/K4 per BERT-base forward at that batch
        **({"bert_launches": {
            **{f"nlp {run}": r["counts"][key] for run, r in bert["nlp"].items()},
            **{f"serving {mode}": r["counts"][key] for mode, r in bert["serving"].items()}}}
           if key in ("K1", "K2", "K4") else {}),
        # the mesh runs of phase 4 and 5 (launches per run; every product
        # partitioned, a launch per cell) and phase 3's M = 4 timings of the
        # whole call and the partitioned one over a virtual (2, 4) mesh
        **({"mesh_launches": (
            {"mesh PACKED (2, 4)": mesh["mesh PACKED"]["counts"]["K4"],
             "paged speculative depth 2 (2, 4)": mesh_model["paged_launches"]["K4"]}
            if key == "K4" else {"mesh w4a8 (1, 4)": llama["w4a8"]["mesh"]["counts"]["K5"]}),
            "sharded_call_ms": {f"4x{k}x{n} on 2x{k}x{n // 4} shards": {
                "unsharded_ms": t[key], "sharded_ms": t[f"{key} sharded"]}
                for (k, n), t in mesh_times.items()}}
           if key in ("K4", "K5") else {}),
        **({"per_bert_forward": {"launches": bert_per_forward(bert_spec())[0],
                                 **{f: bert_gemms[key][f] for f in (
                                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}}
           if key in bert_gemms else {}),
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
    served += "".join(
        f"; Llama-3-8B {run}: " + (
            f"acceptance {r['acceptance']:.4f}, {r['tokens_per_slot_round']:.3f} tokens a slot "
            f"a round, {1e3 * r['step_s'] / r['steps']:.2f} ms a round" if "acceptance" in r
            else "admission ms " + str([round(1e3 * t, 2) for t in r["admit_s"]]))
        + f", relative RMS to the plain run {r['verdict']['rms']:.4g}"
        for run, r in prefix_spec.items())
    served += "".join(
        f"; Llama-3-8B {run}: median step {r['step_ms_median']:.2f} ms (dense einsum "
        f"{r['dense_step_ms']:.2f}), peak {r['peak_gb']:.3f} GB (dense einsum "
        f"{r['dense_peak_gb']:.3f}), {r['peak_pages']} pages at the peak, gather "
        f"{r['gather_ms']:.3f} device ms a step, bit-equal {r['exact']}"
        for run, r in paged.items() if run in ("paged FAST", "paged PACKED"))
    phase("done", f"ms/img: approx {approx_ms:.2f}, published {pub_ms:.2f}, "
                  + ", ".join(f"{mode} {serving[mode][1]:.2f}" for mode in SERVING_FLAGS)
                  + "; CNN ms/img at batch 16: "
                  + ", ".join(f"{run} {c[1]:.2f}" for run, c in cnn.items())
                  + f" (CNN runs and checks {cnn_s:.1f} s); int8 conv sums per batch-16 "
                  "forward: " + ", ".join(
                      f"{arch} {t['ms']:.3f} ms (cuDNN f32 {t['library_ms']:.3f}, bound "
                      f"{t['bound_ms']:.3f})" for arch, t in int8_conv.items())
                  + "; MSE runs (calibration s over 2 batches, ms/img, eval ms/img): "
                  + ", ".join(f"{run} {r['calib_s']:.2f} s, {r['ms']:.2f}, {r['eval_ms']:.2f}"
                              for run, r in mse.items())
                  + "; " + ", ".join(f"{run} {r['ms']:.2f} ms/img (eval {r['eval_ms']:.2f})"
                                     for run, r in special.items())
                  + f", OF/UF against K3 at batch {ORACLE_BATCH}: top-1 agreement "
                  f"{special['OF/UF oracle']['agreement']:.4f}, logits' relative RMS "
                  f"{special['OF/UF oracle']['rel_rms']:.4g}"
                  f"; MSE depth-2 host re-search: {mse_model['tensor_diff']} of "
                  f"{mse_model['tensor_sites']} per-tensor sites, {mse_model['channel_diff']} of "
                  f"{mse_model['channels']} sampled channels differ; this slice's runs and "
                  f"checks {mse_s:.1f} s"
                  + "; demo ms/img " + ", ".join(
                      f"{m} {r[1]:.3f}" for m, r in surgery_io["demo"].items())
                  + "; surgery model ms/img " + ", ".join(
                      f"{m} {r[1]:.3f}" for m, r in surgery_io["surgery"].items())
                  + f", K3 per forward {k3_surgery['ms']:.3f} ms (bound "
                  f"{k3_surgery['bound_ms']:.4f}); --model-dir " + ", ".join(
                      f"{run} load {r['load_s']:.2f} s port {r['port_s']:.3f} s "
                      f"{r['ms']:.2f} ms/img" for run, r in surgery_io["model_dir"].items())
                  + f"; checkpoint {surgery_io['checkpoint']['mib']:.1f} MiB, restored run "
                  f"{surgery_io['checkpoint']['restored_ms']:.2f} ms/img; --images-dir "
                  + (", ".join(f"{k} {v:.2f} ms/img" for k, v in surgery_io["images"].items())
                     or "not run")
                  + f"; the weights, images, demo and surgery checks {surgery_kernels_s:.1f} s "
                  "and runs "
                  f"{surgery_io['seconds']:.1f} s"
                  + "; BERT-base at 32x128: " + ", ".join(
                      f"{mode} {r['ms']:.2f} ms a batch (busy {r['busy']:.3f})"
                      for mode, r in bert["serving"].items())
                  + "; K2 / K4 per BERT-base forward " + ", ".join(
                      f"{key} {t['ms']:.3f} ms (bound {t['bound_ms']:.3f}, torch.matmul "
                      f"{t['library_ms']:.3f})" for key, t in bert_gemms.items())
                  + f"; nlp --model-dir load {bert['nlp']['--model-dir']['load_s']:.2f} s, port "
                  f"{bert['nlp']['--model-dir']['port_s']:.3f} s; the BERT checks and runs "
                  f"{bert_s:.1f} s"
                  + "; train-qat MobileNetV2 at batch " + f"{QAT_BATCH}: " + ", ".join(
                      f"{mode} median step {r['step_ms']:.1f} ms, run {r['wall_s']:.1f} s"
                      for mode, r in qat["runs"].items())
                  + f", frozen fraction {qat['runs']['osc']['frozen']:.4g}, card step against "
                  f"the CPU's relative RMS {qat['rms']:.4g}, ladder " + ", ".join(
                      f"{name} {r['ms']:.2f} ms a step ({r['launches']} launches, busy "
                      f"{r['busy']:.3f})" for name, r in qat["ladder"].items())
                  + f", the phase {qat['seconds']:.1f} s"
                  + f"; foreign ViT-B/16 by interception {slice17['foreign']['ms_per_img']:.2f} "
                  f"ms/img, K3 {slice17['foreign']['trace']['ms']:.3f} device ms a forward "
                  f"(QuantizedViT {PORT_VIT_K3_MS}); rank-3 approx ms a forward " + ", ".join(
                      f"{name} {r['ms']:.3f}" for name, r in slice17["rank3"]["k3"].items())
                  + f"; the interception, rank-3 and grid phases {slice17['seconds']:.1f} s"
                  + f"; the mesh: ring prefill of {RING_TOKENS} tokens "
                  f"{mesh['ring prefill']['ring_ms']:.1f} ms (dense einsum "
                  f"{mesh['ring prefill']['dense_ms']:.1f}), mesh PACKED (2, 4) median step "
                  f"{mesh['mesh PACKED']['step_ms_median']:.2f} ms (single device "
                  f"{llama['packed']['step_ms_median']:.2f}), shards "
                  f"{mesh['mesh PACKED']['shards_gb']:.2f} GB, peak "
                  f"{mesh['mesh PACKED']['peak_gb']:.2f} GB, mesh w4a8 (1, 4) median step "
                  f"{llama['w4a8']['mesh']['step_ms_median']:.2f} ms (single device "
                  f"{llama['w4a8']['step_ms_median']:.2f}); the depth-2 mesh batchers "
                  f"{mesh_model['seconds']:.1f} s"
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
