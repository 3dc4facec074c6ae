"""Command-line interface: ``validate-quantized`` and
``validate-quantized-demo`` (port of ``cli.py``).

Same commands, flags and defaults as the JAX package's CLI, so the
reference's flag sets (``scripts/image_net.sh``) run unchanged:

    python -m fp8_quantization_tpu_torch.cli validate-quantized \\
        --architecture vit_quantized_approx --synthetic-data ... \\
        --approx_flag --withComp --with_approx

The port runs ``vit_quantized``, ``mobilenet_v2_quantized``,
``resnet18_quantized``, ``resnet50_quantized``, their ``_approx`` twins and
``demo_quantized``, in the fixed phase (with ``--reestimate-bn-batches`` for
the CNNs' BN) and in the serving modes ``--fast-mode``, ``--packed-weights``
and ``--chained-acts``, with the FP quantizer and with the uniform ones
(int8 and int4 conv and dense serving), with every range estimator (the MSE
search with its mantissa-width election among them) and every run method
(the approximate multiplier, its OF/UF adder, self-check and debug modes
through the plain oracle, and quantize-after-mult-and-add).

Weights: seeded random ones, or ``--model-dir``: a torch state dict
(``.pth``, ``.pth.tar``, ``.pt``, ``.bin``; torchvision / reference CNN and
HF ViT names, through ``models.porting``) or a checkpoint of the port's own
(``utils.checkpoint``, which ``--save-checkpoint-dir`` writes after the run).
Data: synthetic batches, or ``--images-dir``: evaluation from ``<dir>/val``,
calibration and BN re-estimation batches from ``<dir>/train``
(``eval.data``; ``--native-loader`` decodes the val batches in C++ threads,
``eval.native_data``). The mesh flags raise.
``--cuda`` (the default) runs on the GPU and raises when there is none;
``--no-cuda`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch

from . import LATER as _LATER
from .config import (
    ApproxConfig,
    EstimatorConfig,
    FP8Config,
    OptMethod,
    QMethod,
    QuantConfig,
    RangeMethod,
    RunMethodConfig,
)

logger = logging.getLogger("fp8_quantization_tpu_torch")

ARCH_CHOICES = [
    "mobilenet_v2_quantized",
    "resnet18_quantized",
    "resnet50_quantized",
    "vit_quantized",
    "demo_quantized",
    "mobilenet_v2_quantized_approx",
    "resnet18_quantized_approx",
    "resnet50_quantized_approx",
    "vit_quantized_approx",
]


def _add_bool_flag(p, name: str, default: bool, help: str = ""):
    """click-style ``--x/--no-x`` flag pair."""
    dest = name.replace("-", "_")
    group = p.add_mutually_exclusive_group()
    group.add_argument(f"--{name}", dest=dest, action="store_true", help=help)
    group.add_argument(f"--no-{name}", dest=dest, action="store_false")
    p.set_defaults(**{dest: default})


def _common(p):
    p.add_argument("--images-dir", type=str, default=None)
    p.add_argument("--interpolation", type=str, default="bilinear")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--num-workers", type=int, default=16)
    p.add_argument("--fast-mode", action="store_true")
    p.add_argument("--packed-weights", action="store_true")
    p.add_argument("--chained-acts", action="store_true")
    p.add_argument("--native-loader", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--architecture", type=str, required=True, choices=ARCH_CHOICES)
    p.add_argument("--model-dir", type=str, default=None)
    _add_bool_flag(p, "pretrained", True)
    _add_bool_flag(p, "progress-bar", False)
    p.add_argument("--save-checkpoint-dir", type=str, default=None)
    _add_bool_flag(p, "cuda", True, help="run on the GPU (raises if there is none)")
    p.add_argument("--load-type", type=str, default="fp32",
                   choices=["fp32", "quantized"])

    _add_bool_flag(p, "weight-quant", True)
    _add_bool_flag(p, "act-quant", True)
    p.add_argument("--qmethod", type=str, default="symmetric_uniform",
                   choices=[m.value for m in QMethod])
    p.add_argument("--qmethod-act", type=str, default=None,
                   choices=[m.value for m in QMethod])
    p.add_argument("--weight-quant-method", type=str, default="current_minmax",
                   choices=[m.value for m in RangeMethod])
    p.add_argument("--weight-opt-method", type=str, default="grid",
                   choices=[m.value for m in OptMethod])
    p.add_argument("--num-candidates", type=int, default=None)
    p.add_argument("--n-bits", type=int, default=8)
    p.add_argument("--n-bits-act", type=int, default=None)
    _add_bool_flag(p, "per-channel", False)
    p.add_argument("--act-quant-method", type=str, default="running_minmax",
                   choices=[m.value for m in RangeMethod])
    p.add_argument("--act-opt-method", type=str, default="grid",
                   choices=[m.value for m in OptMethod])
    p.add_argument("--act-num-candidates", type=int, default=None)
    p.add_argument("--act-momentum", type=float, default=None)
    p.add_argument("--num-est-batches", type=int, default=1)
    p.add_argument("--quant-setup", type=str, default="all",
                   choices=["all", "LSQ", "FP_logits", "fc4", "fc4_dw8", "LSQ_paper"])
    _add_bool_flag(p, "quantize-input", False)

    p.add_argument("--fp8-maxval", type=float, default=None)
    p.add_argument("--fp8-mantissa-bits", type=int, default=4)
    _add_bool_flag(p, "fp8-set-maxval", False)
    _add_bool_flag(p, "fp8-learn-maxval", False)
    _add_bool_flag(p, "fp8-learn-mantissa-bits", False)
    _add_bool_flag(p, "fp8-mse-include-mantissa-bits", True)
    _add_bool_flag(p, "fp8-allow-unsigned", False)

    _add_bool_flag(p, "approx_flag", False)
    _add_bool_flag(p, "quantize-after-mult-and-add", False)
    _add_bool_flag(p, "res-quantizer-flag", False)
    _add_bool_flag(p, "original-quantize-res", False)

    p.add_argument("--expo-width", type=int, default=3)
    p.add_argument("--mant-width", type=int, default=4)
    p.add_argument("--dnsmp-factor", type=int, default=3)
    _add_bool_flag(p, "withComp", False)
    _add_bool_flag(p, "with_approx", False)
    _add_bool_flag(p, "with_s2nn2s_opt", False)
    _add_bool_flag(p, "sim_hw_add_OFUF", False)
    _add_bool_flag(p, "with_OF_opt", False)
    _add_bool_flag(p, "with_UF_opt", False)
    _add_bool_flag(p, "golden-clip-OF", False)
    _add_bool_flag(p, "quant_btw_mult_accu", True)
    _add_bool_flag(p, "debug-mode", False)
    _add_bool_flag(p, "self-check-mode", False)
    p.add_argument("--approx-output-dir", type=str, default="approx_output")

    p.add_argument("--oscillations-dampen-weight", type=float, default=None)
    p.add_argument("--oscillations-dampen-aggregation", type=str,
                   default="kernel_mean", choices=["sum", "mean", "kernel_mean"])
    p.add_argument("--oscillations-dampen-weight-final", type=float, default=None)
    p.add_argument("--oscillations-dampen-anneal-start", type=float, default=0.25)
    p.add_argument("--oscillations-freeze-threshold", type=float, default=0.0)
    p.add_argument("--oscillations-freeze-ema-momentum", type=float, default=0.001)
    _add_bool_flag(p, "oscillations-freeze-use-ema", True)
    p.add_argument("--oscillations-freeze-max-bits", type=int, default=4)
    p.add_argument("--oscillations-freeze-threshold-final", type=float, default=None)
    p.add_argument("--oscillations-freeze-anneal-start", type=float, default=0.25)

    _add_bool_flag(p, "mini-test", False)
    p.add_argument("--mini-test-batches", type=int, default=10)
    p.add_argument("--mini-test-start", type=int, default=5)
    p.add_argument("--mini-test-step", type=int, default=300)
    p.add_argument("--max-eval-batches", type=int, default=None)
    _add_bool_flag(p, "synthetic-data", False,
                   help="Use deterministic synthetic batches (no dataset)")
    p.add_argument("--reestimate-bn-batches", type=int, default=0)

    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-model", type=int, default=1)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="fp8_quantization_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    _common(sub.add_parser("validate-quantized"))
    _common(sub.add_parser("validate-quantized-demo"))
    return parser


def config_from_args(args) -> QuantConfig:
    """args -> QuantConfig, as the JAX package builds it."""
    weight_range = EstimatorConfig(
        method=RangeMethod(args.weight_quant_method),
        percentile=None,
        num_candidates=args.num_candidates or 111,
        opt_method=OptMethod(args.weight_opt_method),
    )
    act_range = EstimatorConfig(
        method=RangeMethod(args.act_quant_method),
        momentum=args.act_momentum if args.act_momentum is not None else 0.9,
        num_candidates=args.act_num_candidates or args.num_candidates or 111,
        opt_method=OptMethod(args.act_opt_method),
    )
    return QuantConfig(
        method=QMethod(args.qmethod),
        act_method=QMethod(args.qmethod_act) if args.qmethod_act else None,
        n_bits=args.n_bits,
        n_bits_act=args.n_bits_act,
        per_channel_weights=args.per_channel,
        quantize_input=(args.quantize_input or args.quant_setup == "LSQ_paper"),
        quant_setup=args.quant_setup,
        weight_range=weight_range,
        act_range=act_range,
        fp8=FP8Config(
            maxval=args.fp8_maxval,
            mantissa_bits=args.fp8_mantissa_bits,
            set_maxval=args.fp8_set_maxval,
            learn_maxval=args.fp8_learn_maxval,
            learn_mantissa_bits=args.fp8_learn_mantissa_bits,
            mse_include_mantissa_bits=args.fp8_mse_include_mantissa_bits,
            allow_unsigned=args.fp8_allow_unsigned,
        ),
        run_method=RunMethodConfig(
            approx_flag=args.approx_flag,
            quantize_after_mult_and_add=args.quantize_after_mult_and_add,
            res_quantizer_flag=args.res_quantizer_flag,
            original_quantize_res=args.original_quantize_res,
        ),
        approx=ApproxConfig(
            expo_width=args.expo_width,
            mant_width=args.mant_width,
            dnsmp_factor=args.dnsmp_factor,
            with_comp=args.withComp,
            with_approx=args.with_approx,
            with_s2nn2s_opt=args.with_s2nn2s_opt,
            sim_hw_add_ofuf=args.sim_hw_add_OFUF,
            with_of_opt=args.with_OF_opt,
            with_uf_opt=args.with_UF_opt,
            golden_clip_of=args.golden_clip_OF,
            quant_btw_mult_accu=args.quant_btw_mult_accu,
            debug_mode=args.debug_mode,
            self_check_mode=args.self_check_mode,
        ),
    )


def select_device(use_cuda: bool) -> torch.device:
    """The GPU when ``use_cuda`` (raising when there is none), else the CPU."""
    if not use_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--cuda was given but no CUDA device is available "
                           "(pass --no-cuda to run on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def build_model(arch: str, qc: QuantConfig, device, generator, spec=None):
    """(model on ``device``, zeros example batch of one). ``spec`` defaults to
    the architecture's full size (ViT-B/16, MobileNetV2 1.0 at 224,
    ResNet-18/50 at 224; the demo's one 10->10 dense). Weights are drawn on
    the CPU from ``generator`` and then moved, so a seed gives the same
    weights on every device."""
    base = arch.replace("_approx", "")
    if base == "vit_quantized":
        from .models.vit import VIT_B_16, QuantizedViT

        model = QuantizedViT(qc=qc, spec=spec or VIT_B_16, generator=generator)
    elif base == "mobilenet_v2_quantized":
        from .models.mobilenet_v2 import MOBILENET_V2, QuantizedMobileNetV2

        model = QuantizedMobileNetV2(qc=qc, spec=spec or MOBILENET_V2, generator=generator)
    elif base in ("resnet18_quantized", "resnet50_quantized"):
        from .models.resnet import QuantizedResNet, ResNetSpec

        model = QuantizedResNet(qc=qc, spec=spec or ResNetSpec(depth=int(base[6:8])),
                                generator=generator)
    elif base == "demo_quantized":
        from .models.demo import QuantizedDemoModel

        model = QuantizedDemoModel(qc, generator=generator).to(device)
        return model, torch.zeros((1, model.features), device=device)
    else:
        raise ValueError(f"unknown architecture {arch}")
    model = model.to(device)
    size = model.spec.image_size
    return model, torch.zeros((1, size, size, 3), device=device)


def load_weights(arch: str, model, model_dir):
    """Load ``--model-dir`` into ``model`` in place: a torch state dict
    (``models.porting.TORCH_SUFFIXES``) through ``models.porting``, read with
    ``weights_only=True``, anything else as a checkpoint of the port's own
    (``utils.checkpoint``). Returns the model."""
    if model_dir is None:
        logger.warning("no --model-dir given; using randomly initialized weights")
        return model
    from .models import porting

    if model_dir.endswith(porting.TORCH_SUFFIXES):
        state = torch.load(model_dir, map_location="cpu", weights_only=True)
        ported = porting.port_architecture(arch, state, model)
        model.load_state_dict(porting.merge_ported(model.state_dict(), ported))
        return model
    from .utils.checkpoint import load_checkpoint

    return load_checkpoint(model_dir, model)


def _reject_unported(args):
    if args.mesh_data * args.mesh_model > 1:
        raise NotImplementedError(f"--mesh-data / --mesh-model {_LATER}")


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(args):
    """(model, device, qc, example): the device, the configuration, the model
    with its init forward done and the zeros example batch it was done on,
    and then its ``--model-dir`` weights loaded, as ``validate-quantized``
    starts."""
    from .quant.sites import ESTIMATE, reset_search_grids
    from .utils.misc import seed_all

    _reject_unported(args)
    if args.seed is not None:
        seed_all(args.seed)
    device = select_device(args.cuda)
    # full-f32 products and convolutions on the GPU: TF32 (cuDNN's default
    # for convolutions) keeps ~3 decimal digits and would move values off
    # the quantization grid the reference computes on
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    qc = config_from_args(args)
    generator = torch.Generator().manual_seed(args.seed or 0)
    model, example = build_model(args.architecture, qc, device, generator)
    # the JAX CLI initializes its variables with an ESTIMATE-phase forward of
    # a zeros example (flax ``model.init``), which seeds every site's range
    # state; the port does the same so both calibrate from the same state,
    # but for the MSE and cross-entropy searches, whose grids it leaves to
    # the first calibration batch (``quant.sites.reset_search_grids``)
    with torch.no_grad():
        model(example, ESTIMATE)
    reset_search_grids(model)
    # as the JAX CLI, the weights come after the init forward (a checkpoint
    # brings its own site state)
    load_weights(args.architecture, model, args.model_dir)
    return model, device, qc, example


def _demo_batches(args, max_batches=None):
    """The demo's batches: seeded (B, 10) normal inputs and labels in 0..9."""
    import numpy as np

    rng = np.random.default_rng(args.seed or 0)
    return [(rng.normal(size=(args.batch_size, 10)).astype(np.float32),
             rng.integers(0, 10, size=(args.batch_size,)))
            for _ in range(max_batches or 4)]


def make_batches(args, model, max_batches=None):
    """The eval batches: the demo's, ``--synthetic-data`` ones for
    ``model``'s input size, or ``<--images-dir>/val`` (through the native
    loader under ``--native-loader`` where it builds)."""
    from .eval import data

    if args.architecture == "demo_quantized":
        return _demo_batches(args, max_batches)
    size = model.spec.image_size
    if args.synthetic_data or not args.images_dir:
        return data.synthetic_batches(args.batch_size, max_batches or 8, image_size=size,
                                      num_classes=model.spec.num_classes,
                                      seed=args.seed or 10)
    if args.native_loader:
        from .eval import native_data

        if native_data.available():
            return native_data.imagenet_val_batches_native(
                args.images_dir, args.batch_size, image_size=size, max_batches=max_batches,
                num_threads=args.num_workers)
        print("warning: native loader unavailable, using PIL pipeline")
    return data.imagenet_val_batches(args.images_dir, args.batch_size, image_size=size,
                                     max_batches=max_batches)


def make_train_batches(args, model, max_batches=None):
    """Calibration and BN re-estimation batches: from ``<--images-dir>/train``
    (the reference feeds its train loader), else as :func:`make_batches`."""
    from .eval import data

    if args.architecture == "demo_quantized" or args.synthetic_data or not args.images_dir:
        return make_batches(args, model, max_batches)
    return data.imagenet_train_batches(args.images_dir, args.batch_size,
                                       image_size=model.spec.image_size,
                                       max_batches=max_batches, seed=args.seed or 10)


def run_validate(args) -> dict:
    """Build (and load ``--model-dir``), calibrate, (re-estimate BN,)
    evaluate, write the result file and (``--save-checkpoint-dir``) save
    the calibrated model. Returns ``{"metrics", "result_file", "device",
    "init_s", "validate_s", "images", "checkpoint"}``: ``validate_s`` is the
    wall time of calibration, BN re-estimation and evaluation, ``images``
    the images those forwards took, ``checkpoint`` the file saved or None."""
    from .eval import data as data_mod
    from .eval.driver import validate_quantized, write_result_file

    t0 = time.perf_counter()
    model, device, qc, example = setup(args)
    sync(device)
    t1 = time.perf_counter()

    # batches are made up front so that the timed run holds no data making
    calib = list(make_train_batches(args, model, args.num_est_batches))[:args.num_est_batches]
    if args.mini_test:
        eval_batches = list(data_mod.strided_batches(
            make_batches(args, model), args.mini_test_batches, args.mini_test_start,
            args.mini_test_step))
    else:
        eval_batches = list(make_batches(args, model, args.max_eval_batches))
    # BN re-estimation batches come from the training data, as calibration's
    bn_batches = (list(make_train_batches(args, model, args.reestimate_bn_batches))
                  [:args.reestimate_bn_batches] if args.reestimate_bn_batches else None)
    t2 = time.perf_counter()
    metrics, calibrated = validate_quantized(
        model, calib, eval_batches, num_est_batches=args.num_est_batches,
        quant_w=args.weight_quant, quant_a=args.act_quant, fast=args.fast_mode,
        packed=args.packed_weights, chained=args.chained_acts, qc=qc,
        calib_example=example, bn_reestimate_batches=bn_batches)
    sync(device)
    t3 = time.perf_counter()

    path = write_result_file(args.approx_output_dir, args.architecture, qc.approx,
                             qc.run_method, metrics)
    print(f"final_metrics: {metrics}")
    print(f"results written to {path}")
    checkpoint = None
    if args.save_checkpoint_dir:
        from .utils.checkpoint import save_checkpoint

        checkpoint = save_checkpoint(args.save_checkpoint_dir, calibrated)
        print(f"checkpoint saved to {args.save_checkpoint_dir}")
    return {"metrics": metrics, "result_file": path, "device": str(device),
            "init_s": t1 - t0, "validate_s": t3 - t2,
            "images": sum(len(y) for _, y in calib + eval_batches + (bn_batches or [])),
            "checkpoint": checkpoint}


def main(argv=None):
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "INFO"))
    args = build_parser().parse_args(argv)
    if args.command in ("validate-quantized", "validate-quantized-demo"):
        return run_validate(args)
    raise SystemExit(f"unknown command {args.command}")


if __name__ == "__main__":
    main(sys.argv[1:])
