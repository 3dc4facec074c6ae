"""The port's quantization stack against the JAX package's, on the same numpy
inputs: range estimators and the FP quantizer (bit-exact), QuantSite state
through ESTIMATE -> FIXED, the layers' im2col and plain paths, and the
config built from the reference's flag set."""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import cli as jcli
from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.ops import layers as jlayers
from fp8_quantization_tpu.quant import estimators as jest
from fp8_quantization_tpu.quant import quantizers as jq
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import cli as tcli
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.ops import layers as tlayers
from fp8_quantization_tpu_torch.quant import estimators as test_
from fp8_quantization_tpu_torch.quant import quantizers as tq
from fp8_quantization_tpu_torch.quant import sites as tsites

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

IMAGE_NET_SH = [
    "validate-quantized", "--synthetic-data", "--architecture", "vit_quantized",
    "--batch-size", "16", "--seed", "10", "--n-bits", "8", "--load-type", "fp32",
    "--quant-setup", "all", "--qmethod", "fp_quantizer", "--per-channel",
    "--fp8-mantissa-bits", "4", "--fp8-set-maxval",
    "--no-fp8-mse-include-mantissa-bits", "--weight-quant-method", "current_minmax",
    "--act-quant-method", "allminmax", "--num-est-batches", "1", "--quantize-input",
    "--no-approx_flag", "--no-quantize-after-mult-and-add", "--res-quantizer-flag",
    "--original-quantize-res", "--expo-width", "3", "--mant-width", "4",
    "--dnsmp-factor", "3", "--approx-output-dir", "approx_output",
]
# the approx run method: the published flag set with the approximate
# multiplier armed in place of --no-approx_flag
APPROX_SH = ([f for f in IMAGE_NET_SH if f != "--no-approx_flag"]
             + ["--approx_flag", "--withComp", "--with_approx"])


def _plain(obj):
    """asdict with enum values, so two packages' configs compare as data."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj.value if isinstance(obj, enum.Enum) else obj


@pytest.mark.parametrize("argv", [IMAGE_NET_SH, APPROX_SH], ids=["published", "approx"])
def test_config_parity_on_image_net_sh(argv):
    jcfg = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    targs = tcli.build_parser().parse_args(argv)
    assert _plain(tcli.config_from_args(targs)) == _plain(jcfg)
    assert targs.cuda is True                     # the card unless --no-cuda
    assert _plain(tc.QuantConfig()) == _plain(jc.QuantConfig())


def _qcfg(mod, per_channel):
    return mod.QuantizerConfig(
        method=mod.QMethod.fp_quantizer, per_channel=per_channel,
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False))


@pytest.mark.parametrize("method", ["current_minmax", "allminmax"])
@pytest.mark.parametrize("per_channel,axis", [(False, -1), (True, -1), (True, 0)])
def test_estimator_ranges_bit_exact(rng, method, per_channel, axis):
    jcfg = jc.EstimatorConfig(jc.RangeMethod(method))
    tcfg = tc.EstimatorConfig(tc.RangeMethod(method))
    shape = (5, 6, 4)
    c = shape[axis] if per_channel else 1
    js = jest.init(jcfg, _qcfg(jc, per_channel), shape, per_channel, axis)
    ts = test_.init(tcfg, _qcfg(tc, per_channel), c)
    for i in range(3):
        x = (rng.normal(size=shape) * (i + 1)).astype(np.float32)
        js, (jmin, jmax, _) = jest.update(jcfg, _qcfg(jc, per_channel), js,
                                          jnp.asarray(x), per_channel, axis)
        ts, (tmin, tmax, _) = test_.update(tcfg, _qcfg(tc, per_channel), ts,
                                           torch.from_numpy(x), per_channel, axis)
        np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
        np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
        for k in ("xmin", "xmax", "count"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def test_fp_quantizer_bit_exact(rng):
    x = (rng.normal(size=(7, 5)) * 3).astype(np.float32)
    for per_channel in (False, True):
        jcfg, tcfg = _qcfg(jc, per_channel), _qcfg(tc, per_channel)
        c = 5 if per_channel else 1
        x_min = np.full((c,), -2.3, np.float32)
        x_max = np.linspace(0.5, 4.0, 5).astype(np.float32)[-c:]
        jst = jq.fp_set_quant_range(jcfg, jq.fp_init(jcfg, 5), jnp.asarray(x_min),
                                    jnp.asarray(x_max))
        tst = tq.fp_set_quant_range(tcfg, tq.fp_init(tcfg, 5), torch.from_numpy(x_min),
                                    torch.from_numpy(x_max))
        for k in jst:
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
        jy, jb = jq.fp_apply(jcfg, jst, jnp.asarray(x), -1)
        ty, tb = tq.fp_apply(tcfg, tst, torch.from_numpy(x), -1)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tq.fp_bias(tcfg, tst).numpy(),
                                      np.asarray(jq.fp_bias(jcfg, jst)))


@pytest.mark.parametrize("per_channel", [False, True])
def test_quant_site_estimate_then_fixed(rng, per_channel):
    """Calibrating a site over two batches and then applying it frozen gives
    the JAX site's state, outputs and exponent bias."""
    jcfg, tcfg = _qcfg(jc, per_channel), _qcfg(tc, per_channel)
    je = jc.EstimatorConfig(jc.RangeMethod.allminmax)
    te = tc.EstimatorConfig(tc.RangeMethod.allminmax)
    xs = [(rng.normal(size=(3, 8)) * s).astype(np.float32) for s in (1.0, 2.5, 0.7)]
    jsite = jsites.QuantSite(jcfg, je, channel_axis=-1)
    variables = jsite.init(jax.random.key(0), jnp.asarray(xs[0]), jsites.ESTIMATE)
    tsite = tsites.QuantSite(tcfg, te, channel_axis=-1, num_channels=8)
    tsite.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, dict(variables))))
    for x in xs[1:]:
        (jy, jb), ups = jsite.apply(variables, jnp.asarray(x), jsites.ESTIMATE,
                                    with_bias=True, mutable=["quant", "quant_est"])
        variables = {**variables, **ups}
        ty, tb = tsite(torch.from_numpy(x), tsites.ESTIMATE, with_bias=True)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    expect = from_jax_variables(jax.tree.map(np.asarray, dict(variables)))
    for k, v in tsite.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), expect[k].numpy())
    x = (rng.normal(size=(4, 8)) * 5).astype(np.float32)
    jy = jsite.apply(variables, jnp.asarray(x), jsites.FIXED)
    np.testing.assert_array_equal(tsite(torch.from_numpy(x), tsites.FIXED).numpy(),
                                  np.asarray(jy))
    np.testing.assert_array_equal(
        tsite.fp_bias().numpy(),
        np.asarray(jsite.apply(variables, method=jsites.QuantSite.fp_bias)))


def test_unported_pieces_raise():
    # the serving phases (fast, packed, chained) are ported; these are not
    with pytest.raises(NotImplementedError):
        tsites.QuantPhase(phase="fixed", grad_scaling=True)
    # BN re-estimation is ported (the CNN slice); LSQ gradient scaling is not
    assert tsites.QuantPhase(phase="fixed", reestimate_bn=True).reestimate_bn
    uniform = tc.QuantizerConfig(method=tc.QMethod.symmetric_uniform)
    with pytest.raises(NotImplementedError):
        tq.apply(uniform, tq.init(uniform), torch.ones(3), grad_scaling=True)
    with pytest.raises(NotImplementedError):
        tsites.QuantSite(_qcfg(tc, False), tc.EstimatorConfig(tc.RangeMethod.MSE))
    with pytest.raises(NotImplementedError):
        tlayers.QuantConv(tc.QuantConfig(), 4, 4, kernel_size=(3,))


@pytest.mark.parametrize("padding,strides,dilation", [
    ("SAME", (2, 2), (1, 1)),
    ("VALID", (1, 2), (2, 1)),
    ([(1, 0), (2, 1)], (1, 1), (1, 1)),
])
def test_conv_patches_match_jax(rng, padding, strides, dilation):
    x = rng.normal(size=(2, 9, 7, 3)).astype(np.float32)
    kshape = (3, 2, 3, 5)
    jp = np.asarray(jlayers.conv_patches(jnp.asarray(x), kshape, strides, padding, dilation))
    tp = tlayers.conv_patches(torch.from_numpy(x), kshape, strides, padding, dilation)
    np.testing.assert_array_equal(tp.numpy(), jp)


def _layer_qc(mod):
    return mod.QuantConfig(
        method=mod.QMethod.fp_quantizer, per_channel_weights=True, quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True))


def test_quant_conv_plain_path_matches_jax(rng):
    """A strided SAME conv through ESTIMATE then FIXED: the same site state
    and, up to f32 summation order, the same output. Integer-valued operands
    keep every product and sum exact, so the res-quantized outputs agree
    bit for bit."""
    x = rng.integers(-3, 4, size=(2, 8, 8, 3)).astype(np.float32)
    jconv = jlayers.QuantConv(qc=_layer_qc(jc), features=4, kernel_size=(3, 3),
                              strides=(2, 2), padding="SAME")
    variables = jconv.init(jax.random.key(1), jnp.asarray(x), jsites.ESTIMATE)
    params = dict(variables["params"])
    params["kernel"] = jnp.asarray(rng.integers(-2, 3, size=(3, 3, 3, 4)).astype(np.float32))
    variables = {**variables, "params": params}
    tconv = tlayers.QuantConv(_layer_qc(tc), 3, 4, kernel_size=(3, 3), strides=(2, 2),
                              padding="SAME")
    tconv.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, dict(variables))))
    _, ups = jconv.apply(variables, jnp.asarray(x), jsites.ESTIMATE,
                         mutable=["quant", "quant_est"])
    variables = {**variables, **ups}
    with torch.no_grad():
        tconv(torch.from_numpy(x), tsites.ESTIMATE)
        ty = tconv(torch.from_numpy(x), tsites.FIXED).numpy()
    expect = from_jax_variables(jax.tree.map(np.asarray, dict(variables)))
    for k, v in tconv.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), expect[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(ty, np.asarray(jconv.apply(variables, jnp.asarray(x))))
