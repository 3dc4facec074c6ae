"""The CNN serving boundary of the port on whole models, against the JAX
package's, on the CPU: MobileNetV2 (width 0.25, its table cut to
``test_torch_cnn_mobilenet.CUT_SETTING``) and ResNet-18, both on 32x32
images, under the int8 flags of ``scripts/bench_cnn.py`` (configuration B)
and MobileNetV2 under the published FP8 flags (configuration A), in the
PACKED and CHAINED (fused ``Affine`` boundary) phases; and
``validate-quantized --no-cuda`` in configurations A, B, C (w4a8) and D
(ViT-B/16's int8 flags, on a tiny ``ViTSpec``).

Each model's JAX ``init`` (an ESTIMATE forward of the calibration batch)
calibrates it, its BN variances are set so that ``var + eps`` is a power of
four (``test_torch_cnn_serving.exact_bn``: XLA's CPU ``rsqrt`` is not
correctly rounded, and its ulp, folded into a pending ``Affine``, can move a
code at a rounding midpoint), and the port loads that state through
``models.bridge`` and caches and packs its own weights. JAX serves the port's packed caches
(``port_caches``): the caches of both sides are held equal layer by layer in
``tests/test_torch_cnn_serving.py``, and JAX's packing of a whole model
compiles its operations one layer shape at a time (35 s for the FP8
MobileNetV2 on this CPU). Tolerances, those of ``tests/test_conv_serving.py``
(BN's ``rsqrt`` and the frameworks' summation orders move the logits by
ulps, which at a rounding midpoint become a grid step):

* int8: CHAINED against PACKED within ``rtol = atol = 5e-4`` with the same
  top-1, and each phase against JAX's within the same;
* FP8: CHAINED against PACKED within ``5e-3``, top-1 agreement of at least
  0.9 and every disagreeing row a near tie (its top-2 margin within 4 x
  max|d|); each phase against JAX's within ``5e-3`` and the same rule.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import cli as tcli
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.eval.driver import cache_quantized_weights as t_cache
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.mobilenet_v2 import MobileNetV2Spec
from fp8_quantization_tpu_torch.models.resnet import ResNetSpec
from fp8_quantization_tpu_torch.models.vit import ViTSpec
from fp8_quantization_tpu_torch.ops import fastpath
from fp8_quantization_tpu_torch.quant import sites as tsites
from fp8_quantization_tpu_torch.models import mobilenet_v2 as t_mobilenet
from test_torch_cnn_mobilenet import (  # noqa: F401  (the autouse fixture)
    CLASSES, FULL_SETTING, MODELS, SIZE, _cut_mobilenet, _launches)
from test_torch_cnn_serving import exact_bn, fp8_qc, tree, uniform_qc

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

INT8_TOL = dict(rtol=5e-4, atol=5e-4)
FP8_TOL = dict(rtol=5e-3, atol=5e-3)
CONFIGS = {"int8": (lambda mod: uniform_qc(mod, res=False), INT8_TOL),
           "fp8": (fp8_qc, FP8_TOL)}


def port_caches(tm):
    """The port model's packed weight codes as a JAX ``quant_cache`` tree."""
    out = {}
    for key, value in tm.state_dict().items():
        *path, name = key.split(".")
        if name.startswith(("w_i8", "w_i4", "w_codes", "w_pack_bias")):
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[name] = jnp.asarray(value.numpy())
    return out


def agree(ours, theirs, tol, name):
    """``tol``, and top-1 agreement of at least 0.9 with every disagreeing
    row a near tie."""
    np.testing.assert_allclose(ours, theirs, err_msg=name, **tol)
    same = ours.argmax(-1) == theirs.argmax(-1)
    assert same.mean() >= 0.9, (name, same.mean())
    dev = np.abs(ours - theirs).max()
    for i in np.flatnonzero(~same):
        top2 = np.sort(theirs[i])[-2:]
        assert top2[1] - top2[0] <= 4 * dev, (name, i, top2, dev)


@pytest.mark.parametrize("arch,kind", [("mobilenet_v2", "int8"), ("resnet18", "int8"),
                                       ("mobilenet_v2", "fp8")])
def test_chained_against_packed_and_jax(arch, kind):
    """Calibrate on one batch, cache (fast) and pack, then evaluate another:
    CHAINED against PACKED, and each against JAX's (module docstring). The
    int8 models serve every conv through ``quantized_conv_int8`` (the f32
    kernels are stripped) and launch no kernel on the CPU."""
    make_qc, tol = CONFIGS[kind]
    rng = np.random.default_rng(0)
    calib, x = (rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))
    jm = MODELS[arch][0](make_qc(jc))
    variables = exact_bn(tree(jax.jit(lambda k, c: jm.init(k, c, jsites.ESTIMATE))(
        jax.random.key(0), jnp.asarray(calib))))
    tm = MODELS[arch][1](make_qc(tc))
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    t_cache(tm, calib, fast=True)
    _, report = fastpath.pack_dense_caches(tm, make_qc(tc))
    convs = [m for m in tm.modules() if hasattr(m, "groups")]
    assert len(report) == len(convs) + 1                # every conv and the classifier
    jv = {**variables, "quant_cache": port_caches(tm)}
    fastpath.strip_packed_params(tm)
    if kind == "int8":
        assert all(m.kernel is None and m.w_i8 is not None for m in convs)
    before = _launches()
    logits = {}
    with torch.no_grad():
        for name in ("PACKED", "CHAINED"):
            ours = tm(torch.from_numpy(x), getattr(tsites, name)).float().numpy()
            theirs = np.asarray(jax.jit(lambda v, x, qp=getattr(jsites, name): jsites.decoded(
                jm.apply(v, x, qp)))(jv, jnp.asarray(x)), np.float32)
            assert np.isfinite(ours).all() and ours.shape == (2, CLASSES), name
            agree(ours, theirs, tol, name)
            logits[name] = ours
    agree(logits["CHAINED"], logits["PACKED"], tol, "CHAINED against PACKED")
    if kind == "int8":
        np.testing.assert_array_equal(logits["CHAINED"].argmax(-1), logits["PACKED"].argmax(-1))
        assert _launches() == before


BASE = ["validate-quantized", "--synthetic-data", "--no-cuda", "--batch-size", "2",
        "--max-eval-batches", "1", "--num-est-batches", "1"]
PUBLISHED_FP8 = ["--qmethod", "fp_quantizer", "--per-channel", "--fp8-set-maxval",
                 "--no-fp8-mse-include-mantissa-bits", "--weight-quant-method",
                 "current_minmax", "--act-quant-method", "allminmax", "--quantize-input",
                 "--res-quantizer-flag", "--original-quantize-res"]
INT8 = ["--qmethod", "symmetric_uniform", "--per-channel", "--weight-quant-method",
        "current_minmax", "--act-quant-method", "allminmax", "--quantize-input",
        "--packed-weights"]
CLI_RUNS = {
    "A_mobilenet_v2": ("mobilenet_v2_quantized", PUBLISHED_FP8 + [
        "--fast-mode", "--packed-weights", "--chained-acts"]),
    "B_resnet18_packed": ("resnet18_quantized", INT8),
    "B_mobilenet_v2_chained": ("mobilenet_v2_quantized", INT8 + ["--chained-acts"]),
    "C_mobilenet_v2_w4a8_chained": ("mobilenet_v2_quantized", INT8 + [
        "--n-bits", "4", "--n-bits-act", "8", "--chained-acts"]),
    "D_vit_chained": ("vit_quantized", INT8 + ["--chained-acts"]),
    # the CLI's default act estimator, running_minmax
    "B_default_estimator": ("mobilenet_v2_quantized", [
        "--per-channel", "--quantize-input", "--packed-weights", "--chained-acts"]),
}
SPECS = {
    "mobilenet_v2_quantized": MobileNetV2Spec(num_classes=CLASSES, width_mult=0.25,
                                              image_size=SIZE),
    "resnet18_quantized": ResNetSpec(depth=18, num_classes=CLASSES, image_size=SIZE),
    "vit_quantized": ViTSpec(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
                             patch_size=8, image_size=SIZE, num_classes=CLASSES),
}


@pytest.mark.parametrize("run", list(CLI_RUNS), ids=list(CLI_RUNS))
def test_cli_serving_on_cpu(run, tmp_path, monkeypatch):
    """``validate-quantized --no-cuda`` in each configuration on a small
    model: build, calibrate, cache and pack, evaluate, write the result
    file, with finite metrics and no kernel launch (the CPU runs the plain
    versions); the int8 runs serve every conv from its integer codes. The
    CLI feeds a model images of its own size, so MobileNetV2 runs its whole
    table at 32x32."""
    arch, flags = CLI_RUNS[run]
    monkeypatch.setattr(t_mobilenet, "INVERTED_RESIDUAL_SETTING", FULL_SETTING)
    monkeypatch.setattr(tcli, "build_model", functools.partial(tcli.build_model,
                                                               spec=SPECS[arch]))
    calls = []
    real = fastpath.quantized_conv_int8

    def counted(*args, **kw):
        calls.append(kw["as_affine"])
        return real(*args, **kw)

    monkeypatch.setattr(fastpath, "quantized_conv_int8", counted)
    before = _launches()
    out = tcli.main(BASE + ["--architecture", arch, "--approx-output-dir", str(tmp_path)]
                    + flags)
    assert _launches() == before
    assert out["device"] == "cpu" and np.isfinite(out["metrics"]["loss"])
    assert out["result_file"].startswith(str(tmp_path / arch))
    chained = "--chained-acts" in flags
    if "symmetric_uniform" in flags or run == "B_default_estimator":
        assert calls and all(a == chained for a in calls)
    else:
        assert not calls
