"""The port's quantized ResNets against the JAX package's on the CPU:
ResNet-18 at full width on 32x32 images, batch 2, 10 classes, calibrated
and evaluated under the published flags as ``tests/test_torch_cnn_mobilenet.py``
holds MobileNetV2 (its docstring gives the flow, the tolerances and where
ResNet's approx products are held); one ResNet-50 ``QuantBottleneck``
against JAX and the whole ResNet-50 built and run with no JAX compile; and
``validate-quantized --architecture resnet18_quantized`` on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.models.resnet import QuantBottleneck as JBottleneck
from fp8_quantization_tpu.quant.sites import QuantPhase as JPhase
from fp8_quantization_tpu_torch import cli as tcli
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.resnet import QuantBottleneck as TBottleneck
from fp8_quantization_tpu_torch.models.resnet import QuantizedResNet as TResNet
from fp8_quantization_tpu_torch.models.resnet import ResNetSpec
from fp8_quantization_tpu_torch.ops import layers as tlayers
from fp8_quantization_tpu_torch.quant import sites as tsites
from test_torch_cnn_mobilenet import (
    CLASSES, GRID_STEP, PUBLISHED, SEED, SIZE, STATE_TOL, STEP_FRACTION, _launches, _qc,
    _tree, check_calibrate_and_evaluate)

torch.set_num_threads(1)  # the suite's test workers share the machine's cores


def test_resnet18_calibrate_and_evaluate_match_jax():
    check_calibrate_and_evaluate("resnet18")


def test_resnet50_bottleneck_matches_jax_and_full_model_builds(rng):
    """One ``QuantBottleneck`` with a strided downsample, against JAX
    (ESTIMATE then FIXED, the tolerances of the module docstring), and the
    whole ResNet-50 built and run at 32x32 with no JAX compile: 54 products
    (stem, 16 x 3, 4 downsamples, fc), the flax names, finite logits."""
    x = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    xe = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    jb = JBottleneck(qc=_qc(jc, False), width=32, stride=2, downsample=True)
    variables = _tree(jax.jit(lambda k, c: jb.init(k, c, JPhase(phase="estimate")))(
        jax.random.key(SEED), jnp.asarray(x)))
    tb = TBottleneck(_qc(tc, False), 64, 32, stride=2, downsample=True)
    tb.load_state_dict(from_jax_variables({k: variables[k] for k in ("params", "batch_stats")}),
                       strict=False)
    with torch.no_grad():
        tb(torch.from_numpy(x), tsites.ESTIMATE)
    expect = from_jax_variables({k: variables[k] for k in ("quant", "quant_est")})
    for key, value in expect.items():
        np.testing.assert_allclose(tb.state_dict()[key].numpy(), value.numpy(), err_msg=key,
                                   **STATE_TOL)
    want = np.asarray(jax.jit(lambda v, x: jb.apply(v, x, JPhase()))(variables, jnp.asarray(xe)))
    with torch.no_grad():
        got = tb(torch.from_numpy(xe), tsites.FIXED).numpy()
    assert got.shape == want.shape == (2, 4, 4, 128)
    # a residual site's output is on its FP8 grid: one step is 2^-4 relative
    apart = np.abs(got - want) > GRID_STEP * np.maximum(np.abs(got), np.abs(want))
    assert apart.mean() <= STEP_FRACTION

    tm = TResNet(_qc(tc, False), ResNetSpec(depth=50, num_classes=CLASSES, image_size=SIZE))
    products = [n for n, m in tm.named_modules()
                if isinstance(m, (tlayers.QuantConv, tlayers.QuantDense))]
    assert len(products) == 54 and "layer1_0.downsample_0" in products and "fc" in products
    assert hasattr(tm, "layer4_2_activation_quantizer")
    assert not hasattr(tm.layer4_2, "activation_quantizer")
    with torch.no_grad():
        tm(torch.zeros(1, SIZE, SIZE, 3), tsites.ESTIMATE)
        out = tm(torch.from_numpy(xe[:, :, :, :3].repeat(4, 1).repeat(4, 2)), tsites.FIXED)
    assert out.shape == (2, CLASSES) and bool(torch.isfinite(out).all())


def test_cli_resnet18_on_cpu(tmp_path, monkeypatch):
    """``validate-quantized --no-cuda --architecture resnet18_quantized`` with
    the published flags and one BN re-estimation batch, at 32x32: build,
    calibrate, re-estimate, evaluate, write the result file; no kernel
    launches on the CPU."""
    monkeypatch.setattr(tcli, "build_model", functools.partial(
        tcli.build_model, spec=ResNetSpec(depth=18, num_classes=CLASSES, image_size=SIZE)))
    launches = _launches()
    out = tcli.main(PUBLISHED + ["--architecture", "resnet18_quantized",
                                 "--reestimate-bn-batches", "1",
                                 "--approx-output-dir", str(tmp_path)])
    assert _launches() == launches
    assert out["device"] == "cpu" and out["images"] == 6
    assert np.isfinite(out["metrics"]["loss"])
    assert out["result_file"].startswith(str(tmp_path / "resnet18_quantized" / "E3M4D3"))
