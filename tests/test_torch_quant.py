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
    # the serving phases (fast, packed, chained) and every range estimator
    # are ported (tests/test_torch_estimators.py), and so is LSQ gradient
    # scaling (the QAT slice, tests/test_torch_qat.py): a phase carries it
    assert tsites.QuantPhase(phase="fixed", grad_scaling=True).grad_scaling
    # BN re-estimation is ported (the CNN slice)
    assert tsites.QuantPhase(phase="fixed", reestimate_bn=True).reestimate_bn
    # LSQ gradient scaling leaves the forward as it is, bit for bit JAX's,
    # and scales the step's gradient by (int_max * elements) ** -0.5
    uniform = tc.QuantizerConfig(method=tc.QMethod.symmetric_uniform)
    j_uniform = jc.QuantizerConfig(method=jc.QMethod.symmetric_uniform)
    x = torch.tensor([0.3, -2.0, 1.7])
    state = dict(tq.init(uniform), delta=torch.tensor([0.5], requires_grad=True))
    y = tq.apply(uniform, state, x, grad_scaling=True)
    j_state = dict(jq.init(j_uniform), delta=jnp.asarray([0.5], jnp.float32))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jq.apply(
        j_uniform, j_state, jnp.asarray(x.numpy()), grad_scaling=True)))
    y.sum().backward()
    plain = dict(state, delta=torch.tensor([0.5], requires_grad=True))
    tq.apply(uniform, plain, x).sum().backward()
    torch.testing.assert_close(state["delta"].grad, plain["delta"].grad * (127 * 3) ** -0.5)
    # spatial ranks 1 to 3 are ported, as JAX's any-rank conv runs them
    # (PyTorch has no convolution of rank 4)
    assert tlayers.QuantConv(tc.QuantConfig(), 4, 4, kernel_size=(3,)).strides == (1,)
    conv3 = tlayers.QuantConv(tc.QuantConfig(), 4, 4, kernel_size=(3, 3, 3))
    assert conv3.strides == (1, 1, 1) and conv3.kernel.shape == (3, 3, 3, 4, 4)
    with pytest.raises(ValueError):
        tlayers.QuantConv(tc.QuantConfig(), 4, 4, kernel_size=(3, 3, 3, 3))


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


def test_qama_matmul_2d_matches_jax(rng):
    """``qama_matmul_2d`` on random operands with an FP8 res quantizer: the
    same result up to the order of the K-sum before its requant (one grid
    step where a sum lies at a rounding midpoint), and the same with rows in
    chunks of one."""
    from fp8_quantization_tpu.numerics.fp8_ste import quantize_to_fp8_ste as j_ste
    from fp8_quantization_tpu_torch.numerics.fp8_ste import quantize_to_fp8_ste as t_ste

    x = (rng.normal(size=(9, 24)) * 2).astype(np.float32)
    w = rng.normal(size=(24, 7)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, w: jlayers.qama_matmul_2d(
        x, w, lambda t: j_ste(t, 8, jnp.asarray([6.0]), 4.0, 1)[0]))(x, w))
    res_q = lambda t: t_ste(t, 8, torch.tensor([6.0]), 4.0, 1)[0]  # noqa: E731
    got = tlayers.qama_matmul_2d(torch.from_numpy(x), torch.from_numpy(w), res_q)
    step = t_ste(torch.from_numpy(want.copy()), 8, torch.tensor([6.0]), 4.0, 1)[0]
    assert np.abs(got.numpy() - want).max() <= 2.0 ** -3
    assert (got.numpy() == want).mean() >= 0.95 and np.array_equal(step.numpy(), want)
    old = tlayers.ORACLE_CHUNK_ELEMENTS
    try:
        tlayers.ORACLE_CHUNK_ELEMENTS = 1
        assert torch.equal(tlayers.qama_matmul_2d(torch.from_numpy(x), torch.from_numpy(w),
                                                  res_q), got)
    finally:
        tlayers.ORACLE_CHUNK_ELEMENTS = old


def test_qama_quant_dense_matches_jax(rng):
    """A ``QuantDense`` under quantize-after-mult-and-add through ESTIMATE
    then FIXED: the same site state and, with integer operands (every sum
    exact), the same output bit for bit."""
    qc = lambda mod: dataclasses.replace(  # noqa: E731
        _layer_qc(mod), run_method=mod.RunMethodConfig(
            res_quantizer_flag=True, original_quantize_res=True,
            quantize_after_mult_and_add=True))
    x = rng.integers(-3, 4, size=(2, 5, 12)).astype(np.float32)
    jd = jlayers.QuantDense(qc=qc(jc), features=6)
    variables = jax.jit(jd.init, static_argnums=2)(jax.random.key(1), jnp.asarray(x),
                                                   jsites.ESTIMATE)
    params = {"kernel": jnp.asarray(rng.integers(-2, 3, size=(12, 6)).astype(np.float32)),
              "bias": jnp.asarray(rng.integers(-2, 3, size=6).astype(np.float32))}
    variables = {**variables, "params": params}
    td = tlayers.QuantDense(qc(tc), 12, 6)
    td.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, dict(variables))))
    _, ups = jax.jit(lambda v, x: jd.apply(v, x, jsites.ESTIMATE,
                                           mutable=["quant", "quant_est"]))(variables, x)
    variables = {**variables, **ups}
    with torch.no_grad():
        td(torch.from_numpy(x), tsites.ESTIMATE)
        ty = td(torch.from_numpy(x), tsites.FIXED).numpy()
    expect = from_jax_variables(jax.tree.map(np.asarray, dict(variables)))
    for k, v in td.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), expect[k].numpy(), err_msg=k)
    want = np.asarray(jax.jit(lambda v, x: jd.apply(v, x, jsites.FIXED))(variables, x))
    np.testing.assert_array_equal(ty, want)
