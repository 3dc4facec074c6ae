"""The port's quantized MobileNetV2 against the JAX package's, end to end at
a small size on the CPU (``tests/test_torch_cnn_resnet.py`` holds
ResNet-18 the same way): MobileNetV2 at width 0.25 with its
inverted-residual table cut to ``CUT_SETTING`` (four blocks: the t = 1
block, a block with its residual site, and three strides of 2; the full
table's compiled JAX forwards take minutes on the CPU), and ResNet-18 at
full width, both on 32x32 images, batch 2, 10 classes. The cut table
shrinks the image 16-fold, so MobileNetV2 is built for 64x64 images: its
pool window (``input_size // 32``) averages the last 2x2 map.

Each model's JAX ``init`` runs its ESTIMATE forward on the calibration
batch, so one compiled forward both draws the weights and calibrates (under
the reference's flag set, ``scripts/image_net.sh``). The port loads the
drawn weights and BN stats through ``models.bridge`` (the whole variables
tree also loads with ``strict=True``), calibrates from its own fresh site
state on the same batch, and both evaluate another batch: ``FIXED``, and
for MobileNetV2 also ``FAST`` and ``FIXED`` with the approx run method
armed on the same calibrated state (K3 on its ungrouped convs and the
classifier, the oracle on its depthwise ones). The JAX side runs its
approximate products through the jnp oracle (``approx_matmul_2d(...,
allow_pallas=False)``), its plain reference on the CPU; the flagship flags
have no s2nn2s, so no zero mask is involved. Each compiled JAX forward of
these models takes 3–16 s on the CPU, so what the layer tests already hold
is not repeated here: calibration with the approx run method armed, and
the approx products at ResNet's shapes (its 7x7 stem with K = 147 and its
strided 1x1 downsample), are held layer by layer
(``tests/test_torch_cnn_layers.py``), and ResNet-18 is held under the
published flags only.

Tolerances. Every BN layer computes ``rsqrt(var + eps)``; XLA's CPU
``rsqrt`` is not correctly rounded and the frameworks sum convolutions in
other orders, so a BN output can differ from PyTorch's by an ulp, and
where it sits on an FP8 rounding midpoint the next site puts it one grid
step (a relative 2^-4 at E3M4) away; that step carries into the later
ranges and products. So:

* calibrated site state: ``rtol=1e-5``;
* logits (on the classifier's FP8 result grid): the same top-1, and at most
  ``STEP_FRACTION`` of them more than one grid step (``2^-4`` of their
  magnitude) apart.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.models import mobilenet_v2 as j_mobilenet
from fp8_quantization_tpu.models.mobilenet_v2 import QuantizedMobileNetV2 as JMob
from fp8_quantization_tpu.models.resnet import QuantizedResNet as JResNet
from fp8_quantization_tpu.ops import layers as jlayers
from fp8_quantization_tpu.quant.sites import QuantPhase as JPhase
from fp8_quantization_tpu_torch import cli as tcli
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.eval.driver import calibrate as t_calibrate
from fp8_quantization_tpu_torch.models import mobilenet_v2 as t_mobilenet
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.mobilenet_v2 import MobileNetV2Spec
from fp8_quantization_tpu_torch.models.mobilenet_v2 import QuantizedMobileNetV2 as TMob
from fp8_quantization_tpu_torch.models.resnet import QuantizedResNet as TResNet
from fp8_quantization_tpu_torch.models.resnet import ResNetSpec
from fp8_quantization_tpu_torch.ops.cuda import KERNELS
from fp8_quantization_tpu_torch.quant import sites as tsites

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

SEED = 0
SIZE, CLASSES = 32, 10
STATE_TOL = dict(rtol=1e-5, atol=0)
STEP_FRACTION = 0.1
GRID_STEP = 2.0 ** -4


def _qc(mod, approx: bool, quantize_input: bool = True):
    """``scripts/image_net.sh``'s configuration, plus the approx run method."""
    return mod.QuantConfig(
        method=mod.QMethod.fp_quantizer, per_channel_weights=True,
        quantize_input=quantize_input,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False,
                          mantissa_bits=4),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True,
                                       original_quantize_res=True, approx_flag=approx),
        approx=mod.ApproxConfig(with_comp=approx, with_approx=approx))


# MobileNetV2's (t, c, n, s) table cut to four blocks, patched into the JAX
# and port modules alike; the models are built for POOLED_SIZE images
FULL_SETTING = t_mobilenet.INVERTED_RESIDUAL_SETTING
CUT_SETTING = ((1, 16, 1, 2), (6, 24, 2, 2), (6, 32, 1, 2))
POOLED_SIZE = 2 * SIZE

MODELS = {
    "mobilenet_v2": (lambda qc: JMob(qc=qc, num_classes=CLASSES, width_mult=0.25,
                                     input_size=POOLED_SIZE),
                     lambda qc: TMob(qc, MobileNetV2Spec(num_classes=CLASSES, width_mult=0.25,
                                                         image_size=POOLED_SIZE))),
    "resnet18": (lambda qc: JResNet(qc=qc, depth=18, num_classes=CLASSES),
                 lambda qc: TResNet(qc, ResNetSpec(depth=18, num_classes=CLASSES,
                                                   image_size=SIZE))),
}


def _tree(tree):
    return jax.tree.map(np.asarray, dict(tree))


def _inputs():
    rng = np.random.default_rng(SEED)
    return tuple(rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str):
    """The JAX model's init (the ESTIMATE forward of the calibration batch)
    and its logits on the eval batch: FIXED, and for MobileNetV2 also FAST
    and FIXED with the approx run method."""
    calib, x = _inputs()
    jm = MODELS[arch][0](_qc(jc, False))
    variables = jax.jit(lambda k, c: jm.init(k, c, JPhase(phase="estimate")))(
        jax.random.key(SEED), jnp.asarray(calib))
    runs = {"FIXED": (jm, JPhase())}
    if arch == "mobilenet_v2":
        runs["FAST"] = (jm, JPhase(phase="fixed", fast=True))
        runs["approx FIXED"] = (MODELS[arch][0](_qc(jc, True)), JPhase())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "approx_matmul_2d",
                   functools.partial(jlayers.approx_matmul_2d, allow_pallas=False))
        logits = {name: np.asarray(jax.jit(lambda v, x, m=m, qp=qp: m.apply(v, x, qp))(
            variables, jnp.asarray(x)), np.float32) for name, (m, qp) in runs.items()}
    return _tree(variables), logits


@pytest.fixture(autouse=True)
def _cut_mobilenet(monkeypatch):
    monkeypatch.setattr(j_mobilenet, "INVERTED_RESIDUAL_SETTING", CUT_SETTING)
    monkeypatch.setattr(t_mobilenet, "INVERTED_RESIDUAL_SETTING", CUT_SETTING)


def _launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


def _close_logits(ours, theirs, name):
    assert np.isfinite(ours).all() and ours.shape == (2, CLASSES), name
    np.testing.assert_array_equal(ours.argmax(-1), theirs.argmax(-1), err_msg=name)
    scale = np.maximum(np.abs(ours), np.abs(theirs))
    apart = np.abs(ours - theirs) > GRID_STEP * scale
    assert apart.mean() <= STEP_FRACTION, (name, apart.mean(), ours, theirs)


def check_calibrate_and_evaluate(arch):
    """Calibration from fresh site state, then the logits of ``_jax_run``'s
    phases, against JAX (module docstring)."""
    variables, j_logits = _jax_run(arch)
    calib, x = _inputs()

    # every collection lands: no key is left over on either side
    MODELS[arch][1](_qc(tc, False)).load_state_dict(from_jax_variables(variables),
                                                    strict=True)
    tm = MODELS[arch][1](_qc(tc, False))
    weights = {k: variables[k] for k in ("params", "batch_stats")}
    missing, unexpected = tm.load_state_dict(from_jax_variables(weights), strict=False)
    expect = from_jax_variables({k: variables[k] for k in ("quant", "quant_est")})
    assert not unexpected and set(missing) == set(expect)
    launches = _launches()
    t_calibrate(tm, [calib], num_est_batches=1)
    got = tm.state_dict()
    for key, value in expect.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), err_msg=key, **STATE_TOL)
    approx = MODELS[arch][1](_qc(tc, True))
    approx.load_state_dict(tm.state_dict(), strict=True)
    runs = {"FIXED": (tm, tsites.FIXED), "FAST": (tm, tsites.FAST),
            "approx FIXED": (approx, tsites.FIXED)}
    with torch.no_grad():
        for name, want in j_logits.items():
            model, qp = runs[name]
            _close_logits(model(torch.from_numpy(x), qp).float().numpy(), want, name)
    assert _launches() == launches                   # CPU tensors: plain versions


def test_mobilenet_v2_calibrate_and_evaluate_match_jax():
    check_calibrate_and_evaluate("mobilenet_v2")


def test_pool_site_ties_without_quantize_input():
    """MobileNetV2's hoisted pool site: with ``quantize_input`` (the
    published flags) it quantizes only the pool's output, in the call's
    phase, and takes its ranges from it; without, it quantizes the last
    conv's output with range updates and the pool's output with ``FIXED``,
    so its ranges come from the conv's output alone."""
    spec = MobileNetV2Spec(num_classes=CLASSES, width_mult=0.25, image_size=POOLED_SIZE)
    x = torch.from_numpy(_inputs()[0])
    for quantize_input in (True, False):
        tm = TMob(_qc(tc, False, quantize_input), spec,
                  generator=torch.Generator().manual_seed(SEED))
        seen = {}
        last = tm.n_blocks + 1
        conv = getattr(tm, f"features_{last}")
        site = getattr(tm, f"features_{last}_activation_quantizer")
        conv.register_forward_hook(lambda m, i, o: seen.update(conv=o.detach().clone()))
        site.register_forward_hook(lambda m, i, o: seen.setdefault("site", []).append(
            i[0].detach().clone()))
        with torch.no_grad():
            tm(x, tsites.ESTIMATE)
        assert len(seen["site"]) == (1 if quantize_input else 2)
        pooled = seen["site"][-1]
        assert pooled.shape == (2, 1, 1, 1280) and seen["conv"].shape == (2, 2, 2, 1280)
        source = pooled if quantize_input else seen["conv"]
        assert float(site.xmax[0]) == float(source.max())
        assert float(site.xmin[0]) == float(source.min())


PUBLISHED = ["validate-quantized", "--synthetic-data", "--no-cuda", "--batch-size", "2",
             "--max-eval-batches", "1", "--qmethod", "fp_quantizer", "--per-channel",
             "--fp8-set-maxval", "--no-fp8-mse-include-mantissa-bits",
             "--act-quant-method", "allminmax", "--quantize-input", "--res-quantizer-flag",
             "--original-quantize-res"]


@pytest.mark.parametrize("extra", [["--fast-mode", "--packed-weights", "--chained-acts"],
                                   ["--packed-weights", "--qmethod", "symmetric_uniform"]],
                         ids=["chained_acts", "int8_conv_serving"])
def test_cnn_serving_boundary_raises_later_cnn(extra, tmp_path, monkeypatch):
    """``--chained-acts`` (the fused ``Affine`` boundary) and int8 conv
    serving on a CNN, which raised until the CNN serving boundary was
    ported, now run: ``validate-quantized --no-cuda`` on the cut MobileNetV2
    writes its result file with finite metrics. (Their parity with JAX is
    held in ``tests/test_torch_cnn_serving*.py``.) The CLI feeds the model
    images of its own size, so it runs the whole table at 32x32."""
    monkeypatch.setattr(t_mobilenet, "INVERTED_RESIDUAL_SETTING", FULL_SETTING)
    spec = MobileNetV2Spec(num_classes=CLASSES, width_mult=0.25, image_size=SIZE)
    monkeypatch.setattr(tcli, "build_model", functools.partial(tcli.build_model, spec=spec))
    out = tcli.main(PUBLISHED + ["--architecture", "mobilenet_v2_quantized",
                                 "--approx-output-dir", str(tmp_path)] + extra)
    assert out["device"] == "cpu" and np.isfinite(out["metrics"]["loss"])
    assert out["result_file"].startswith(str(tmp_path / "mobilenet_v2_quantized"))
    assert dataclasses.asdict(MobileNetV2Spec()) == dict(num_classes=1000, width_mult=1.0,
                                                         image_size=224)
